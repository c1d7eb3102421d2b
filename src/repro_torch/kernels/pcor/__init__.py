"""SPRINT Pearson correlation: CUDA kernel, plain version, ops."""
