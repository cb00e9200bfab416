"""Tensor programs and the Hopper kernels with their plain versions."""
