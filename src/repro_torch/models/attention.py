"""GQA attention block: param specs + train/prefill/decode application.

Layouts are the reference's: wq (d, h, hd), wk/wv (d, k, hd), wo (h, hd, d),
activations (B, T, H, hd), KV caches (B, S, K, hd), bf16.  Prefill attention
runs in the flash-attention kernel (``kernels/flash_attention/ops.attend``),
which reads the unrepeated K/V and maps query head h to KV head h // (H/K)
itself.  The kernel has no sliding window, as the TPU kernel has none, so a
windowed config computes its prefill with the ``blocked_attention`` twin.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import ACT, TensorSpec, constrain
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import layers
from repro_torch.models.layers import (blocked_attention, decode_attention,
                                       rotary)


class KVCache(NamedTuple):
    k: torch.Tensor     # (B, S, K, hd)
    v: torch.Tensor     # (B, S, K, hd)


def attn_specs(cfg: ArchConfig) -> dict:
    d, h, k, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    out = {
        "wq": TensorSpec((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": TensorSpec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wv": TensorSpec((d, k, hd), ("embed", "kv_heads", "head_dim")),
        "wo": TensorSpec((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.qkv_bias:
        out["bq"] = TensorSpec((h, hd), ("heads", "head_dim"), init="zeros")
        out["bk"] = TensorSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
        out["bv"] = TensorSpec((k, hd), ("kv_heads", "head_dim"), init="zeros")
    return out


def cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                dtype=torch.bfloat16) -> KVCache:
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    shape = (cfg.n_layers, batch, max_len, k, hd)
    axes = (None, "batch", "cache_len", "cache_heads", "head_dim")
    return KVCache(TensorSpec(shape, axes, dtype),
                   TensorSpec(shape, axes, dtype))


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    dt = x.dtype
    q = layers.heads_proj(x, p["wq"].to(dt))
    k = layers.heads_proj(x, p["wk"].to(dt))
    v = layers.heads_proj(x, p["wv"].to(dt))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    q = rotary(q, positions, cfg.rope_theta)
    k = rotary(k, positions, cfg.rope_theta)
    return q, k, v


def attn_train(p: dict, x: torch.Tensor, cfg: ArchConfig,
               positions: torch.Tensor, *, causal: bool = True) -> torch.Tensor:
    """Full-sequence attention (training / encoder)."""
    q, k, v = _qkv(p, x, cfg, positions)
    rep = cfg.n_heads // cfg.n_kv_heads
    out = blocked_attention(q, layers.repeat_kv(k, rep),
                            layers.repeat_kv(v, rep),
                            causal=causal, window=cfg.window)
    return constrain(torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype)),
                     ACT)


def attn_prefill(p: dict, x: torch.Tensor, cfg: ArchConfig,
                 positions: torch.Tensor, *,
                 causal: bool = True) -> tuple[torch.Tensor, KVCache]:
    """Attention that also returns the layer's KV cache: causal (the
    decoder's prefill) or full (the encoder's, ``causal=False``)."""
    q, k, v = _qkv(p, x, cfg, positions)
    # the kernel runs on each rank's rows: batch sharded, heads whole
    q = constrain(q, ("act_batch", None, None, None))
    k = constrain(k, ("act_batch", None, None, None))
    v = constrain(v, ("act_batch", None, None, None))
    if cfg.window:
        rep = cfg.n_heads // cfg.n_kv_heads
        out = blocked_attention(q, layers.repeat_kv(k, rep),
                                layers.repeat_kv(v, rep),
                                causal=causal, window=cfg.window)
    else:
        out = attn_ops.attend(q, k, v, causal=causal)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return constrain(out, ACT), KVCache(k, v)


def _cache_write(cache: torch.Tensor, new: torch.Tensor,
                 index: torch.Tensor) -> torch.Tensor:
    """Write the (B, 1, K, hd) token into row ``index`` of each sequence,
    cast to the cache's dtype.

    The reference selects over the whole cache with a masked ``where``, a
    workaround for its length-sharded cache under GSPMD.  On one device
    the port writes the B rows in place instead: the cache ends up with
    the same values, and the returned tensor is ``cache`` itself.  A
    DTensor cache (a cell on a mesh) takes the reference's select, copied
    back in place: a row write at a run-time index on the length-sharded
    dim has no local strategy, while the select keeps every shard's
    update local and moves no byte.

    ``index``: () shared position, or (B,) per-sequence positions
    (continuous batching — each slot is at its own length).
    """
    if isinstance(cache, DTensor):
        pos = torch.arange(cache.shape[1], dtype=torch.int32,
                           device=cache.device)[None, :, None, None]
        idx = index if index.dim() == 0 else index[:, None, None, None]
        return cache.copy_(torch.where(pos == idx, new.to(cache.dtype),
                                       cache))
    b = cache.shape[0]
    rows = torch.arange(b, device=cache.device)
    cache[rows, index.long().expand(b)] = new[:, 0].to(cache.dtype)
    return cache


def attn_decode(p: dict, x: torch.Tensor, cfg: ArchConfig, cache: KVCache,
                index) -> tuple[torch.Tensor, KVCache]:
    """One-token decode step.  x: (B, 1, D); index: () or (B,) lengths.
    The cache is updated in place (see ``_cache_write``)."""
    b = x.shape[0]
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    idx = index.expand(b) if index.dim() == 0 else index
    q, k, v = _qkv(p, x, cfg, idx[:, None])
    # q is tiny: replicate it across the model axis so the scores keep
    # the CACHE's len-sharding instead of resharding the cache onto q's
    # head sharding
    q = constrain(q, ("act_batch", None, None, None))
    k = constrain(k, ("act_batch", None, None, None))
    v = constrain(v, ("act_batch", None, None, None))
    k_cache = _cache_write(cache.k, k, index)
    v_cache = _cache_write(cache.v, v, index)
    rep = cfg.n_heads // cfg.n_kv_heads
    out = decode_attention(q, layers.repeat_kv(k_cache, rep),
                           layers.repeat_kv(v_cache, rep), kv_len=idx + 1,
                           window=cfg.window)
    out = torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
    return constrain(out, ACT), KVCache(k_cache, v_cache)
