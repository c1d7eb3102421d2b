"""Mamba1 selective-SSM block (falcon-mamba / hymba SSM heads).

Layouts and parameter keys are the reference's (``repro.models.ssm``):
activations (B, T, D), ``in_proj`` (D, 2 Di), ``conv_w`` (d_conv, Di),
``A_log`` (Di, N), caches ``SSMCache(conv (B, d_conv-1, Di), h (B, Di, N))``
in float32.

``ssm_train`` keeps the reference's signature and routes its two callers
apart.  Prefill (``return_state=True``) runs the scan in the
``ssm_scan`` kernel (``kernels/ssm_scan/ops.selective_scan``), which
discretises in place and never builds the (B, T, Di, N) ``abar`` and
``bx``.  The full-sequence forward (``return_state=False``) keeps the
reference's chunked associative scan in plain torch: the independent twin
the kernel's path is checked against.  Decode is the O(1) recurrence
update, and the causal conv is a sum of shifted copies, both plain torch,
as the reference computes them outside any Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ACT, TensorSpec, constrain,
                                              run_local)
from repro_torch.kernels.ssm_scan import ops as ssm_ops


class SSMCache(NamedTuple):
    conv: torch.Tensor  # (B, d_conv-1, Di) last inputs for the causal conv
    h: torch.Tensor     # (B, Di, N) recurrent state


def ssm_specs(cfg: ArchConfig) -> dict:
    d, di, n = cfg.d_model, cfg.d_inner, cfg.ssm.d_state
    r, dc = cfg.dt_rank, cfg.ssm.d_conv
    return {
        "in_proj": TensorSpec((d, 2 * di), ("embed", "inner")),
        "conv_w": TensorSpec((dc, di), ("conv", "inner")),
        "conv_b": TensorSpec((di,), ("inner",), init="zeros"),
        "x_proj": TensorSpec((di, r + 2 * n), ("inner", None)),
        "dt_proj": TensorSpec((r, di), ("dt_rank", "inner")),
        "dt_bias": TensorSpec((di,), ("inner",), init="ones"),
        "A_log": TensorSpec((di, n), ("inner", "state"), init="slow_decay"),
        "D": TensorSpec((di,), ("inner",), init="ones"),
        "out_proj": TensorSpec((di, d), ("inner", "embed")),
    }


def ssm_cache_specs(cfg: ArchConfig, batch: int,
                    dtype=torch.float32) -> SSMCache:
    di, n, dc = cfg.d_inner, cfg.ssm.d_state, cfg.ssm.d_conv
    return SSMCache(
        conv=TensorSpec((cfg.n_layers, batch, dc - 1, di),
                        (None, "batch", None, "inner"), dtype),
        h=TensorSpec((cfg.n_layers, batch, di, n),
                     (None, "batch", "inner", "state"), dtype),
    )


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d via shifted adds.  x: (B, T, Di); w: (dc, Di)."""
    if isinstance(x, DTensor):
        return _conv_local(x, w, b)
    dc, t = w.shape[0], x.shape[1]
    out = x * w[-1].to(x.dtype)
    for i in range(1, dc):
        shifted = F.pad(x, (0, 0, i, 0))[:, :t]
        out = out + shifted * w[dc - 1 - i].to(x.dtype)
    return out + b.to(x.dtype)


def _conv_local(x, w, b):
    """``_causal_conv`` of DTensors (a cell on a mesh) on each rank's rows
    and channels: the depthwise conv runs along T alone.  w and b are
    split as x's channels; each batch shard's rows give them a partial
    gradient."""
    x = constrain(x, ("act_batch", None, "act_inner"))
    px = tuple(x.placements)
    if any(p.is_partial() or p.is_shard() and p.dim == 1 for p in px):
        raise ValueError(f"_causal_conv: x at {px}")
    # per mesh dim: w (dc, Di) and b (Di,) split where x's channels are
    pw = tuple(Shard(1) if p == Shard(2) else Replicate() for p in px)
    pb = tuple(Shard(0) if p == Shard(2) else Replicate() for p in px)
    gw = tuple(Partial() if p == Shard(0) else q for p, q in zip(px, pw))
    gb = tuple(Partial() if p == Shard(0) else q for p, q in zip(px, pb))
    return run_local(_causal_conv, None, (px, pw, pb), px, x,
                     w.redistribute(w.device_mesh, pw),
                     b.redistribute(b.device_mesh, pb),
                     grad_placements=(px, gw, gb))


def _scan_inputs(p: dict, xc: torch.Tensor, cfg: ArchConfig):
    """Input-dependent (dt, B, C) and a = -exp(A_log), all float32."""
    n, r = cfg.ssm.d_state, cfg.dt_rank
    # the rows' (dt, B, C) whole on each rank (a pending sum over split
    # channels reduced here, and so is the gradient on its way back)
    dbc = constrain(xc.float() @ p["x_proj"].float(),
                    ("act_batch", None, None))
    dt, bm, cm = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())                           # (Di, N)
    return dt, bm.contiguous(), cm.contiguous(), a


def _ssm_params(p: dict, xc: torch.Tensor, cfg: ArchConfig):
    """Input-dependent (dt, B, C) + discretized (Abar, Bx)."""
    dt, bm, cm, a = _scan_inputs(p, xc, cfg)
    abar = torch.exp(dt[..., None] * a)                          # (..., Di, N)
    bx = (dt * xc.float())[..., :, None] * bm[..., None, :]
    return abar, bx, cm


def _assoc_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan along dim 1 of the linear recurrence's elements
    (a, b), combined (a1, b1), (a2, b2) -> (a1 a2, a2 b1 + b2): log-depth
    doubling, the reference's ``lax.associative_scan`` in another order."""
    c, off = a.shape[1], 1
    while off < c:
        b = torch.cat([b[:, :off], a[:, off:] * b[:, :-off] + b[:, off:]], 1)
        a = torch.cat([a[:, :off], a[:, off:] * a[:, :-off]], 1)
        off *= 2
    return a, b


def _chunked_scan(abar: torch.Tensor, bx: torch.Tensor, cm: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """Sequential over time chunks carrying h, associative inside each;
    (B, T, Di, N) inputs -> y (B, T, Di) float32.  A short last chunk
    stands in for the reference's identity-padded one."""
    if isinstance(abar, DTensor):
        return _chunked_local(abar, bx, cm, chunk)
    b, t, di, n = abar.shape
    h = abar.new_zeros((b, di, n))
    ys = []
    for s in range(0, t, chunk):
        a_cum, b_cum = _assoc_scan(abar[:, s:s + chunk], bx[:, s:s + chunk])
        hs = a_cum * h[:, None] + b_cum                          # (B,c,Di,N)
        ys.append(torch.einsum("bcdn,bcn->bcd", hs, cm[:, s:s + chunk]))
        h = hs[:, -1]
    return torch.cat(ys, 1)


def _chunked_local(abar, bx, cm, chunk: int):
    """``_chunked_scan`` of DTensors (a cell on a mesh) on each rank's
    rows and channels: the recurrence is independent across both, so each
    local scan is exact.  C is shared by the channels, so where they are
    split its gradient from each rank is a partial sum."""
    chans = ("act_batch", None, "act_inner", None)
    abar, bx = constrain(abar, chans), constrain(bx, chans)
    cm = constrain(cm, ("act_batch", None, None))
    pa, pc = tuple(abar.placements), tuple(cm.placements)
    if any(p.is_partial() or p.is_shard() and p.dim not in (0, 2)
           for p in pa):
        raise ValueError(f"_chunked_scan: abar at {pa}")
    py = tuple(p if p == Replicate() else Shard(p.dim) for p in pa)
    pgc = tuple(Partial() if a == Shard(2) else c for a, c in zip(pa, pc))
    return run_local(functools.partial(_chunked_scan, chunk=chunk), None,
                     (pa, pa, pc), py, abar, bx, cm,
                     grad_placements=(pa, pa, pgc), products=True)


def ssm_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
              chunk: int = 256, return_state: bool = False):
    """Full-sequence selective scan.  x: (B, T, D) -> (B, T, D).

    With ``return_state`` (prefill) also returns the final SSMCache, and
    the scan runs in the ``ssm_scan`` kernel; without it (the full
    forward) in the chunked associative twin."""
    t = x.shape[1]
    xz = x @ p["in_proj"].to(x.dtype)                            # (B,T,2Di)
    xr, z = torch.chunk(xz, 2, dim=-1)
    xc = F.silu(_causal_conv(xr, p["conv_w"], p["conv_b"]))      # (B,T,Di)
    if return_state:
        dt, bm, cm, a = _scan_inputs(p, xc, cfg)
        # the kernel runs on each rank's rows and channels
        chans = ("act_batch", None, "act_inner")
        rows = ("act_batch", None, None)
        # y leaves the scan in f32, as the reference keeps it through + D
        y, h_final = ssm_ops.selective_scan(
            constrain(xc.float(), chans), constrain(dt, chans),
            constrain(bm, rows), constrain(cm, rows),
            constrain(a, ("act_inner", None)), return_state=True)
    else:
        abar, bx, cm = _ssm_params(p, xc, cfg)
        y = _chunked_scan(abar, bx, cm, min(chunk, t))
    y = y + xc.float() * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = constrain(y @ p["out_proj"].to(x.dtype), ACT)
    if not return_state:
        return out
    dc = cfg.ssm.d_conv
    # the last dc - 1 inputs, zeros ahead of a shorter sequence (a slice
    # where T suffices: DTensor's pad cannot place a split batch)
    conv_tail = xr[:, t - (dc - 1):] if t >= dc - 1 else \
        F.pad(xr, (0, 0, dc - 1, 0))[:, t:t + dc - 1]
    return out, SSMCache(conv=conv_tail.float(), h=h_final)


def ssm_decode(p: dict, x: torch.Tensor, cfg: ArchConfig,
               cache: SSMCache) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrence.  x: (B, 1, D).  Returns new cache tensors
    (the caller writes them back)."""
    xz = x @ p["in_proj"].to(x.dtype)
    xr, z = torch.chunk(xz, 2, dim=-1)                           # (B,1,Di)
    # causal conv over [conv_state, x]
    window = torch.cat([cache.conv.to(x.dtype), xr], dim=1)     # (B,dc,Di)
    xc = torch.einsum("bcd,cd->bd", window, p["conv_w"].to(x.dtype)) \
        + p["conv_b"].to(x.dtype)
    xc = F.silu(xc)[:, None]                                     # (B,1,Di)
    abar, bx, cm = _ssm_params(p, xc, cfg)                       # (B,1,Di,N)
    h = abar[:, 0] * cache.h + bx[:, 0]                          # (B,Di,N)
    y = torch.einsum("bdn,bn->bd", h, cm[:, 0])[:, None]         # (B,1,Di)
    y = y + xc.float() * p["D"].float()
    y = y.to(x.dtype) * F.silu(z)
    out = constrain(y @ p["out_proj"].to(x.dtype), ACT)
    return out, SSMCache(conv=window[:, 1:].to(cache.conv.dtype), h=h)
