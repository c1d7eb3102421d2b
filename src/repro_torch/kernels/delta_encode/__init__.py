"""Differencing-snapshot delta probe: CUDA kernel, plain version, ops."""
