"""Mamba1 selective scan: CUDA kernel, plain version, ops."""
