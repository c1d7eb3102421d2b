"""Plain PyTorch versions of the delta kernels (bit-level XOR semantics).

Counterparts of ``repro/kernels/delta_encode/ref.py``'s numpy oracles,
over (nblk, 8, 1024) int32 tile views.  They work on the integer views
alone, never through float arithmetic, so NaN payloads, infinities and
signed zeros survive.  The wrappers in ``kernel.py`` take these for
tensors on the CPU; on the card ``chip_smoke.py`` holds each CUDA kernel
against its plain version bit for bit."""
from __future__ import annotations

import torch


def fused_tiles_ref(o32: torch.Tensor, n32: torch.Tensor):
    """(nblk, 8, 1024) int32 old/new tiles -> (bitmap (nblk,) int32,
    changed XOR tiles (k, 8, 1024) int32 in ascending tile order)."""
    d = torch.bitwise_xor(o32, n32)
    changed = d.reshape(d.shape[0], -1).ne(0).any(dim=1)
    return changed.to(torch.int32), d[changed]


def delta_encode_ref(o32: torch.Tensor, n32: torch.Tensor):
    """(nblk, 8, 1024) int32 old/new tiles -> (XOR delta tiles, (nblk,)
    int32 changed flags)."""
    d = torch.bitwise_xor(o32, n32)
    return d, d.reshape(d.shape[0], -1).ne(0).any(dim=1).to(torch.int32)


def changed_bitmap_ref(o32: torch.Tensor, n32: torch.Tensor) -> torch.Tensor:
    """(nblk, 8, 1024) int32 old/new tiles -> (nblk,) int32, 1 where the
    tile differs anywhere (the flags of ``delta_encode_ref``)."""
    return delta_encode_ref(o32, n32)[1]


def delta_apply_ref(o32: torch.Tensor, d32: torch.Tensor) -> torch.Tensor:
    """(nblk, 8, 1024) int32 old and delta tiles -> new = old ^ delta."""
    return torch.bitwise_xor(o32, d32)
