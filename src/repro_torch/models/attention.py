"""GQA attention block: param specs + the training application.

Layouts are the reference's: wq (d, h, hd), wk/wv (d, k, hd), wo (h, hd, d),
activations (B, T, H, hd).  Prefill, decode and the KV cache come with the
serving slice.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import TensorSpec
from repro_torch.models import layers
from repro_torch.models.layers import blocked_attention, rotary


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


def _qkv(p: dict, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    dt = x.dtype
    q = torch.einsum("btd,dhk->bthk", x, p["wq"].to(dt))
    k = torch.einsum("btd,dhk->bthk", x, p["wk"].to(dt))
    v = torch.einsum("btd,dhk->bthk", x, p["wv"].to(dt))
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
    return torch.einsum("bthk,hkd->btd", out, p["wo"].to(x.dtype))
