"""Public wrapper: the model's layout in, the kernel's layout through.

Model code carries (B, T, H, hd); the kernel takes (B, H, T, hd).
``attend`` transposes, calls ``kernel.flash_attention`` and restores the
layout.  The reference's ``mode`` is gone: the tensors' device picks the
route (the CUDA kernel on the card, its plain version on the CPU).  The
kernel masks a ragged T or S itself, so nothing is padded.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention.kernel import flash_attention


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B,T,H,hd); k,v: (B,S,K,hd) -> (B,T,H,hd)."""
    out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=causal)
    return out.transpose(1, 2)
