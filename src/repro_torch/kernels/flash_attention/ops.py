"""Public wrapper: the model's layout in, the kernel's layout through.

Model code carries (B, T, H, hd); the kernel takes (B, H, T, hd) views.
``attend`` hands it the transposed views of q, k and v and of an output
allocated in (B, T, H, hd): the kernel reads and writes their strides, so
nothing is copied on either side.  The reference's ``mode`` is gone: the
tensors' device picks the route (the CUDA kernel on the card, its plain
version on the CPU).  The kernel masks a ragged T or S itself, so nothing
is padded.

DTensors (a cell on a mesh) must come sharded over the batch only, heads
and positions whole, as the model's constraint leaves them: every rank
then runs the kernel on its own shard, a whole attention problem of its
rows, and the result is sharded as q is.  Nothing is gathered.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import run_local
from repro_torch.kernels.flash_attention.kernel import flash_attention


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True) -> torch.Tensor:
    """q: (B,T,H,hd); k,v: (B,S,K,hd) -> (B,T,H,hd), contiguous."""
    if isinstance(q, DTensor):
        pl = tuple(q.placements)
        if any(p.is_shard() and p.dim != 0 or p.is_partial() for p in pl):
            raise ValueError(f"attend: q at {pl}; shard the batch only")
        return run_local(functools.partial(attend, causal=causal),
                         flash_attention, (pl, pl, pl), pl, q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    flash_attention(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                    causal=causal, out=out.transpose(1, 2))
    return out
