"""Plain PyTorch version of the fused delta probe (bit-level XOR semantics).

The wrapper in ``kernel.py`` takes this path for tensors on the CPU; on the
card ``chip_smoke.py`` holds the CUDA kernel against it bit for bit."""
from __future__ import annotations

import torch


def fused_tiles_ref(o32: torch.Tensor, n32: torch.Tensor):
    """(nblk, 8, 1024) int32 old/new tiles -> (bitmap (nblk,) int32,
    changed XOR tiles (k, 8, 1024) int32 in ascending tile order)."""
    d = torch.bitwise_xor(o32, n32)
    changed = d.reshape(d.shape[0], -1).ne(0).any(dim=1)
    return changed.to(torch.int32), d[changed]
