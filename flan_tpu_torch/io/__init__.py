"""Host-side file codecs (numpy only)."""
