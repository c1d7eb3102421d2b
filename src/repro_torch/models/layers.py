"""Model primitives: norms, rotary, blocked and decode attention, SwiGLU.

Plain functions on tensors, autograd-able, with the reference's layouts
(q (B, T, H, hd), weights (d, h, hd)).  Attention is the online-softmax
blocked formulation, the autograd twin of the reference's flash-attention
kernel; products that the reference asks to accumulate in float32
(``preferred_element_type``) are taken on float32 copies of their inputs.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from repro_torch.distributed.sharding import (ACT, TensorSpec, constrain,
                                              current_rules, run_local)

NEG_INF = -1e30


def rms_norm(x: torch.Tensor, w: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    # variance in f32; x itself stays in its dtype, as in the reference
    var = x.float().square().mean(dim=-1, keepdim=True)
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv * w.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
           w_down: torch.Tensor) -> torch.Tensor:
    h = F.silu(x @ w_gate.to(x.dtype)) * (x @ w_up.to(x.dtype))
    return constrain(h @ w_down.to(x.dtype), ACT)


def heads_proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, D) by w (D, H, hd) -> (B, T, H, hd): ``einsum("btd,dhk->
    bthk")``, taken over w's flattened (H*hd) columns.

    A DTensor's product is placed before the columns are split into
    heads: heads over the model axis where H divides its extent, else
    whole.  Left to itself the product may split the flattened columns
    where H does not divide (8 KV heads of 64 on a model axis of 16), and
    then cannot be unflattened."""
    b, t = x.shape[:2]
    d, h, hd = w.shape
    w2 = w.reshape(d, h * hd)
    sharded = isinstance(x, DTensor)
    if sharded:
        # pins w2's gradient to w2's placements (a redistribute's
        # backward returns its input's), so it too can be split back
        # into heads
        w2 = w2.redistribute(w2.device_mesh, w2.placements)
    y = torch.einsum("btd,dk->btk", x, w2)
    if sharded:
        rules = current_rules()
        spec = rules.spec_for(("act_batch", "act_seq", "act_heads", None),
                              (b, t, h, hd))
        y = y.redistribute(rules.mesh, rules.placements_for(spec[:3]))
    return y.view(b, t, h, hd)


def mlp_specs(d_model: int, d_ff: int) -> dict:
    """SwiGLU params (logical axes kept for the later mesh slice)."""
    return {
        "w_gate": TensorSpec((d_model, d_ff), ("embed", "ff")),
        "w_up": TensorSpec((d_model, d_ff), ("embed", "ff")),
        "w_down": TensorSpec((d_ff, d_model), ("ff", "embed")),
    }


# ---------------------------------------------------------------------------
# Rotary position embeddings
# ---------------------------------------------------------------------------
def rotary(x: torch.Tensor, positions: torch.Tensor,
           theta: float) -> torch.Tensor:
    """x: (B, T, H, hd); positions: (B, T) int32."""
    hd = x.shape[-1]
    exps = -torch.arange(0, hd // 2, dtype=torch.float32,
                         device=x.device) / (hd // 2)
    freqs = torch.pow(torch.tensor(theta, dtype=torch.float32,
                                   device=x.device), exps)
    ang = positions[..., None].float() * freqs             # (B, T, hd/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------
def repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """(B, S, K, hd) -> (B, S, K*n_rep, hd)."""
    if n_rep == 1:
        return k
    b, s, kh, hd = k.shape
    return k[:, :, :, None, :].expand(b, s, kh, n_rep, hd) \
        .reshape(b, s, kh * n_rep, hd)


def blocked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, q_offset: int = 0,
                      kv_len: Optional[torch.Tensor] = None,
                      window: int = 0, block_kv: int = 1024,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Online-softmax attention over KV blocks.

    q: (B, T, H, hd);  k, v: (B, S, H, hd)  (already GQA-repeated).
    ``q_offset``: absolute position of q[0] (decode / chunked prefill).
    ``kv_len``: (B,) valid cache lengths; None = all valid.
    ``window``: sliding-window size (0 = full).
    """
    if isinstance(q, DTensor):
        return _blocked_local(q, k, v, causal=causal, q_offset=q_offset,
                              kv_len=kv_len, window=window,
                              block_kv=block_kv, scale=scale)
    b, t, h, hd = q.shape
    s = k.shape[1]
    dev = q.device
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    block_kv = min(block_kv, s)
    if s % block_kv:
        pad = block_kv - s % block_kv
        k = F.pad(k, (0, 0, 0, 0, 0, pad))
        v = F.pad(v, (0, 0, 0, 0, 0, pad))
        if kv_len is None:
            kv_len = torch.full((b,), s, dtype=torch.int32, device=dev)
        s = s + pad
    nblk = s // block_kv

    pos_q = q_offset + torch.arange(t, dtype=torch.int32, device=dev)
    qf = q.float()
    m = torch.full((b, h, t), NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros((b, h, t), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, t, hd), dtype=torch.float32, device=dev)
    for blk in range(nblk):
        start = blk * block_kv
        kb = k[:, start:start + block_kv]
        vb = v[:, start:start + block_kv]
        scores = torch.einsum("bthd,bshd->bhts", qf, kb.float()) * scale
        pos_k = start + torch.arange(block_kv, dtype=torch.int32, device=dev)
        mask = torch.ones((t, block_kv), dtype=torch.bool, device=dev)
        if causal:
            mask &= pos_k[None, :] <= pos_q[:, None]
        if window:
            mask &= pos_k[None, :] > pos_q[:, None] - window
        scores = torch.where(mask[None, None], scores, NEG_INF)
        if kv_len is not None:
            lmask = pos_k[None, :] < kv_len[:, None]              # (B, Sb)
            scores = torch.where(lmask[:, None, None, :], scores, NEG_INF)
        m_new = torch.maximum(m, scores.amax(dim=-1))             # (B,H,T)
        p = torch.exp(scores - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhts,bshd->bhtd", p.to(v.dtype).float(), vb.float())
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]             # (B,H,T,hd)
    return out.transpose(1, 2).to(q.dtype)                        # (B,T,H,hd)


def _blocked_local(q, k, v, *, kv_len, **kw):
    """``blocked_attention`` of DTensors (a cell on a mesh), on each
    rank's rows and heads: the attention of each (row, head) is
    independent of the others', so with q, k and v placed alike (the
    batch over "act_batch", the GQA-repeated heads over "act_heads"),
    each rank's local call is exact, forward and backward, and no score
    leaves the rank.  (At the DTensor level the products would flatten B
    with H, split over two mesh axes at once, which DTensor's sharding
    propagation takes minutes to place on a 3-axis mesh.)"""
    rows_heads = ("act_batch", None, "act_heads", None)
    q, k, v = (constrain(x, rows_heads) for x in (q, k, v))
    pl = tuple(q.placements)
    if kv_len is not None or any(p.is_partial() or p.is_shard()
                                 and p.dim not in (0, 2) for p in pl):
        raise ValueError(f"blocked_attention: q at {pl}; shard the batch "
                         "and the heads only, with no kv_len")
    fn = functools.partial(blocked_attention, kv_len=None, **kw)
    return run_local(fn, None, (pl, pl, pl), pl, q, k, v, products=True)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, *, kv_len: torch.Tensor,
                     window: int = 0,
                     scale: Optional[float] = None) -> torch.Tensor:
    """Single-step attention over a full cache (no blocking).

    q: (B, 1, H, hd); caches: (B, S, H, hd) (GQA-repeated, bf16 in the
    serving path); kv_len: (B,).  Both products accumulate in float32 on
    float32 copies of their inputs, and the probabilities are rounded to
    the cache's dtype before P·V, as in the reference.
    """
    # q is tiny: its heads whole on each rank, so that the scores keep the
    # cache's len-sharding (no product flattens B with split heads)
    q = constrain(q, ("act_batch", None, None, None))
    hd = q.shape[-1]
    s = k_cache.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    scores = torch.einsum("bthd,bshd->bhts", q.float(),
                          k_cache.float()) * scale
    # scores inherit the cache's len-sharding; softmax reduces over the
    # sharded dim with tiny (B,H,T) collectives
    scores = constrain(scores, ("act_batch", None, None, "cache_len"))
    pos_k = torch.arange(s, dtype=torch.int32, device=q.device)
    mask = pos_k[None, :] < kv_len[:, None]                       # (B,S)
    if window:  # sliding-window: only the last `window` positions attend
        mask &= pos_k[None, :] >= kv_len[:, None] - window
    scores = torch.where(mask[:, None, None, :], scores, NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhts,bshd->bthd", p.to(v_cache.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab_size: int) -> torch.Tensor:
    """Mean CE per token; logits may be vocab-padded (padded cols masked)."""
    padded = logits.shape[-1]
    if padded != vocab_size:
        col = torch.arange(padded, device=logits.device)
        logits = torch.where(col[None, None, :] < vocab_size, logits,
                             NEG_INF)
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if isinstance(logits, DTensor):
        # vocab-sharded logits: each shard selects its own label column
        # and the sum over vocab adds one value to zeros, exactly the
        # gathered one (DTensor's gather of a sharded dim fails)
        col = torch.arange(padded, device=logits.device)
        ll = torch.where(col == labels.long()[..., None], logits,
                         0.0).sum(-1)
    else:
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    return torch.mean(lse - ll)
