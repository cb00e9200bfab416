"""Function layer and interpolators."""
