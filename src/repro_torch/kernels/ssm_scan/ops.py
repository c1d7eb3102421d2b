"""Public wrapper of the selective-scan kernel
(``repro.kernels.ssm_scan.ops.selective_scan``).

The reference's ``mode`` is gone: the tensors' device picks the route
(the CUDA kernel on the card, its plain version on the CPU).  The kernel
takes any T and Di and masks the ragged edge itself, so the reference's
T and Di padding is not needed on either route.

DTensors (a cell on a mesh) run the kernel on each rank's local shards.
The scan is independent across the batch and across channels, so x and
dt may be sharded over B and Di, bm and cm over B, and a over Di as x
is: each shard's scan is exact, and y and the state come back sharded
as x is.  Nothing is gathered.
"""
from __future__ import annotations

import functools

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.distributed.sharding import run_local
from repro_torch.kernels.ssm_scan.kernel import ssm_scan


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, *,
                   return_state: bool = False):
    """x, dt: (B,T,Di); bm, cm: (B,T,N); a: (Di,N) -> (B,T,Di), and with
    ``return_state`` also the final state (B,Di,N) in float32."""
    if isinstance(x, DTensor):
        return _sharded(x, dt, bm, cm, a, return_state)
    return ssm_scan(x, dt, bm, cm, a, return_state=return_state)


def _sharded(x, dt, bm, cm, a, return_state: bool):
    px = tuple(x.placements)
    if any(p.is_partial() or p.is_shard() and p.dim == 1 for p in px):
        raise ValueError(f"selective_scan: x at {px}; shard B and Di only")
    # per mesh dim: bm/cm keep x's batch split; a and the state take its
    # channel split at their own channel dim
    pbc = tuple(p if p == Shard(0) else Replicate() for p in px)
    pa = tuple(Shard(0) if p == Shard(2) else Replicate() for p in px)
    ph = tuple(Shard(1) if p == Shard(2) else p for p in px)
    fn = functools.partial(ssm_scan, return_state=return_state)
    return run_local(fn, ssm_scan, (px, px, pbc, pbc, pa),
                     (px, ph) if return_state else px, x, dt, bm, cm, a)
