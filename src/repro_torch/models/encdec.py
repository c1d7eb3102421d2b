"""Encoder–decoder backbone (seamless-m4t-medium): training forward,
prefill, decode.

The audio frontend is a stub, as in the reference: ``api.input_specs``
declares precomputed frame embeddings (B, S_enc, D) that go straight into
the encoder.  The decoder is a causal transformer with cross-attention to
the encoder output; decode carries a self-attention KV cache of
``max_len`` and a cross-attention KV cache computed once by prefill from
the encoder output and frozen after it.  RMSNorm throughout, as in the
reference.

Written in ``lm.py``'s idiom: the layer weights stay stacked (L, ...)
under ``enc_layers`` and ``dec_layers``, so snapshot keys and shapes are
the reference's, and its ``lax.scan`` becomes a Python loop over
``p[i]``.  Caches are the reference's ``{"self_kv": KVCache, "cross_kv":
KVCache}``, stacked (L, B, S, K, hd) in bf16.

Prefill runs every attention in the flash-attention kernel
(``attn_ops.attend``): the encoder's self-attention and the
cross-attention non-causal, the decoder's self-attention causal, 3 x L
launches a call on the card.  Training (``forward_train``) computes them
with the ``blocked_attention`` twin, as the reference does: the kernel
has no backward in either package.
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ACT, TensorSpec, constrain,
                                              stack_specs)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.models import attention, layers
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import (RunConfig, cast_tree, embed_tokens,
                                   pad_cache, recompute_under_rules, unembed)

# encoder frames backing a decode-time cross-attention cache
ENC_LEN_DECODE = 4096


def enc_block_specs(cfg: ArchConfig) -> dict:
    return {
        "ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "attn": attention.attn_specs(cfg),
        "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def dec_block_specs(cfg: ArchConfig) -> dict:
    return {
        "ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "self_attn": attention.attn_specs(cfg),
        "ln_x": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "cross_attn": attention.attn_specs(cfg),
        "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff),
    }


def encdec_specs(cfg: ArchConfig) -> dict:
    vp = cfg.padded_vocab()
    return {
        "embed": TensorSpec((vp, cfg.d_model), ("vocab", "embed")),
        "enc_layers": stack_specs(enc_block_specs(cfg), cfg.n_layers),
        "dec_layers": stack_specs(dec_block_specs(cfg), cfg.n_layers),
        "enc_norm": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
        "lm_head": TensorSpec((cfg.d_model, vp), ("embed", "vocab")),
    }


def encdec_cache_specs(cfg: ArchConfig, batch: int, max_len: int,
                       enc_len: int = ENC_LEN_DECODE) -> dict:
    k, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    self_shape = (cfg.n_layers, batch, max_len, k, hd)
    cross_shape = (cfg.n_layers, batch, enc_len, k, hd)
    axes = (None, "batch", "cache_len", "cache_heads", "head_dim")
    return {
        "self_kv": KVCache(TensorSpec(self_shape, axes, torch.bfloat16),
                           TensorSpec(self_shape, axes, torch.bfloat16)),
        "cross_kv": KVCache(TensorSpec(cross_shape, axes, torch.bfloat16),
                            TensorSpec(cross_shape, axes, torch.bfloat16)),
    }


def _layer(tree, i: int):
    return tu.tree_map(lambda a: a[i], tree)


def _positions(x: torch.Tensor) -> torch.Tensor:
    b, t = x.shape[:2]
    return torch.arange(t, dtype=torch.int32, device=x.device).expand(b, t)


def _mlp(cfg: ArchConfig, lp: dict, x: torch.Tensor) -> torch.Tensor:
    xn2 = layers.rms_norm(x, lp["ln2"], cfg.rms_eps)
    m = lp["mlp"]
    return x + layers.swiglu(xn2, m["w_gate"], m["w_up"], m["w_down"])


def encode(params: dict, cfg: ArchConfig, frames: torch.Tensor,
           run: RunConfig = RunConfig(), *,
           kernel: bool = False) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed embeddings (stub frontend).

    Non-causal self-attention with rotary over frame positions.  With
    ``kernel`` (prefill) each layer's attention is one flash-attention
    launch; without it (training) the ``blocked_attention`` twin, under
    ``torch.utils.checkpoint`` with ``run.remat_policy()``."""
    x = constrain(frames.to(run.compute_dtype), ACT)
    positions = _positions(x)
    enc_params = cast_tree(params["enc_layers"], run.compute_dtype)

    def body(x, lp):
        xn = layers.rms_norm(x, lp["ln1"], cfg.rms_eps)
        if kernel:
            a, _ = attention.attn_prefill(lp["attn"], xn, cfg, positions,
                                          causal=False)
        else:
            a = attention.attn_train(lp["attn"], xn, cfg, positions,
                                     causal=False)
        return constrain(_mlp(cfg, lp, x + a), ACT)

    policy = None if kernel else run.remat_policy()
    for i in range(cfg.n_layers):
        lp = _layer(enc_params, i)
        if policy is not None:
            x = checkpoint(body, x, lp, use_reentrant=False,
                           context_fn=recompute_under_rules(policy))
        else:
            x = body(x, lp)
    return layers.rms_norm(x, params["enc_norm"], cfg.rms_eps)


def _cross_kv(lp: dict, enc_out: torch.Tensor) -> KVCache:
    """The cross-attention's K and V of the encoder output: no rotary, no
    biases."""
    dt = enc_out.dtype
    return KVCache(layers.heads_proj(enc_out, lp["wk"].to(dt)),
                   layers.heads_proj(enc_out, lp["wv"].to(dt)))


def _cross_attend(lp: dict, xn: torch.Tensor, cfg: ArchConfig,
                  kv: KVCache, *, kernel: bool = False) -> torch.Tensor:
    """Cross-attention: q from the decoder, k/v (B, S, K, hd) from the
    encoder output or its cache, cast to the compute dtype first.  No
    rotary and no biases, even where ``qkv_bias`` is set.  One query
    (decode) attends over the whole cache with ``decode_attention``;
    with ``kernel`` (prefill) the query rows go to the flash-attention
    kernel on the unrepeated K/V; else (training) to the
    ``blocked_attention`` twin."""
    dt = xn.dtype
    q = layers.heads_proj(xn, lp["wq"].to(dt))
    k, v = kv.k.to(dt), kv.v.to(dt)
    if kernel:
        # the kernel runs on each rank's rows: batch sharded, heads whole
        rows = ("act_batch", None, None, None)
        out = attn_ops.attend(constrain(q, rows), constrain(k, rows),
                              constrain(v, rows), causal=False)
    else:
        rep = cfg.n_heads // cfg.n_kv_heads
        k, v = layers.repeat_kv(k, rep), layers.repeat_kv(v, rep)
        if xn.shape[1] == 1:
            kv_len = torch.full((xn.shape[0],), k.shape[1],
                                dtype=torch.int32, device=xn.device)
            out = layers.decode_attention(q, k, v, kv_len=kv_len)
        else:
            out = layers.blocked_attention(q, k, v, causal=False)
    return constrain(torch.einsum("bthk,hkd->btd", out, lp["wo"].to(dt)),
                     ACT)


def forward_train(params: dict, cfg: ArchConfig, frames: torch.Tensor,
                  tokens: torch.Tensor, run: RunConfig = RunConfig()):
    """Teacher-forced training forward.  frames: (B, S, D); tokens:
    (B, T) -> (logits (B, T, Vp), {})."""
    enc_out = encode(params, cfg, frames, run)
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    positions = _positions(x)
    dec_params = cast_tree(params["dec_layers"], run.compute_dtype)

    def body(x, lp):
        xn = layers.rms_norm(x, lp["ln1"], cfg.rms_eps)
        x = x + attention.attn_train(lp["self_attn"], xn, cfg, positions)
        xc = layers.rms_norm(x, lp["ln_x"], cfg.rms_eps)
        x = x + _cross_attend(lp["cross_attn"], xc, cfg,
                              _cross_kv(lp["cross_attn"], enc_out))
        return constrain(_mlp(cfg, lp, x), ACT)

    policy = run.remat_policy()
    for i in range(cfg.n_layers):
        lp = _layer(dec_params, i)
        if policy is not None:
            x = checkpoint(body, x, lp, use_reentrant=False,
                           context_fn=recompute_under_rules(policy))
        else:
            x = body(x, lp)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    logits = constrain(unembed(params, cfg, x),
                       ("act_batch", "act_seq", "act_vocab"))
    return logits, {}


def prefill(params: dict, cfg: ArchConfig, frames: torch.Tensor,
            tokens: torch.Tensor, max_len: int,
            run: RunConfig = RunConfig()):
    """Encode, then a teacher-forced decoder pass building both caches.

    Returns (logits (B, Vp) of the last position, caches): ``self_kv``
    allocated at ``max_len`` so decode continues in place, ``cross_kv``
    at the frames' length.  The cross K/V are rounded to bf16 before
    the cross-attention reads them, at any compute dtype, as in the
    reference."""
    enc_out = encode(params, cfg, frames, run, kernel=True)
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    positions = _positions(x)
    dec_params = cast_tree(params["dec_layers"], run.compute_dtype)
    per_layer = []
    for i in range(cfg.n_layers):
        lp = _layer(dec_params, i)
        xn = layers.rms_norm(x, lp["ln1"], cfg.rms_eps)
        a, self_kv = attention.attn_prefill(lp["self_attn"], xn, cfg,
                                            positions)
        x = x + a
        xc = layers.rms_norm(x, lp["ln_x"], cfg.rms_eps)
        cross_kv = KVCache(*(c.to(torch.bfloat16) for c in
                             _cross_kv(lp["cross_attn"], enc_out)))
        x = x + _cross_attend(lp["cross_attn"], xc, cfg, cross_kv,
                              kernel=True)
        x = constrain(_mlp(cfg, lp, x), ACT)
        per_layer.append({"self_kv": pad_cache(self_kv, max_len),
                          "cross_kv": cross_kv})
    x = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    logits = unembed(params, cfg, x)[:, 0]
    return logits, tu.tree_map(lambda *ls: torch.stack(ls), *per_layer)


def decode_step(params: dict, cfg: ArchConfig, caches: dict,
                tokens: torch.Tensor, index,
                run: RunConfig = RunConfig()):
    """One-token decoder step against the frozen cross cache.  tokens:
    (B, 1); index: scalar current length, or (B,) per-sequence lengths.
    Returns (logits (B, 1, Vp), caches): the self cache is written in
    place at ``index``, the cross cache is returned untouched."""
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    dec_params = cast_tree(params["dec_layers"], run.compute_dtype)
    for i in range(cfg.n_layers):
        lp = _layer(dec_params, i)
        cache = _layer(caches, i)                    # views of layer i
        xn = layers.rms_norm(x, lp["ln1"], cfg.rms_eps)
        a, _ = attention.attn_decode(lp["self_attn"], xn, cfg,
                                     cache["self_kv"], index)
        x = x + a
        xc = layers.rms_norm(x, lp["ln_x"], cfg.rms_eps)
        x = x + _cross_attend(lp["cross_attn"], xc, cfg, cache["cross_kv"])
        x = constrain(_mlp(cfg, lp, x), ACT)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), caches
