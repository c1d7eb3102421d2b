"""Analytic cost model: MODEL_FLOPS and ideal HBM traffic per cell.

MODEL_FLOPS follows the assignment: 6*N*D for training (2*N*D for inference
kinds), N = active matmul params (MoE: shared + top_k routed only; input
embedding-table lookups excluded, tied embeddings counted once as the LM
head).  The causal-attention quadratic term is tracked separately and added
for the "useful flops" numerator so long-context cells aren't unfairly
penalized.

HBM bytes is an *ideal minimum traffic* inventory (params/optimizer/grads,
saved activations under the remat policy, KV-cache traffic, logits) — the
right denominator for a memory roofline: compiled code can only be worse.
Per-device figures assume the resolver's shardings.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.models.lm import RunConfig


def matmul_params(cfg: ArchConfig, active: bool = False) -> int:
    """Params participating in matmuls per token (excl. input embed gather)."""
    n = cfg.active_param_count() if active else cfg.param_count()
    vp = cfg.vocab_size * cfg.d_model
    if cfg.tie_embeddings:
        return n            # single table, used as the lm_head matmul
    return n - vp           # drop the input embedding gather table


def attention_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """Score+output matmul FLOPs (fwd), causal-halved; 0 for attention-free."""
    if cfg.attention_free:
        return 0.0
    hd = cfg.resolved_head_dim
    b, t = shape.global_batch, shape.seq_len
    if shape.kind == "decode":
        # one token attends to the whole cache
        per_layer = 2 * 2 * b * cfg.n_heads * t * hd
    else:
        per_layer = 2 * 2 * b * cfg.n_heads * t * t * hd * 0.5
        if cfg.window:
            per_layer = 2 * 2 * b * cfg.n_heads * t * min(cfg.window, t) * hd
    layers = cfg.n_layers * (2 if cfg.enc_dec else 1)
    if cfg.enc_dec:  # cross attention (decoder) q*t x kv*t
        layers += cfg.n_layers
    return per_layer * layers


@dataclass
class ModelCost:
    model_flops: float           # 6ND / 2ND (global)
    model_flops_w_attn: float    # + attention quadratic (fwd-scaled)
    hbm_bytes_per_device: float  # ideal traffic per device per step


def analytic_cost(cfg: ArchConfig, shape: ShapeConfig, n_devices: int,
                  run: RunConfig = RunConfig()) -> ModelCost:
    n_active = matmul_params(cfg, active=True)
    n_total = cfg.param_count()
    d_tokens = shape.tokens_per_step
    vp = cfg.padded_vocab()

    if shape.kind == "train":
        flops = 6.0 * n_active * d_tokens
        attn = 3.0 * attention_flops(cfg, shape)          # fwd+bwd
        if run.remat in ("full", "dots"):
            flops *= 4.0 / 3.0                            # recompute fwd
            attn *= 4.0 / 3.0
    else:
        flops = 2.0 * n_active * d_tokens
        attn = attention_flops(cfg, shape)

    # ---------- ideal HBM traffic ----------
    b, t = shape.global_batch, shape.seq_len
    d = cfg.d_model
    p_local = n_total / n_devices
    layers = cfg.n_layers * (2 if cfg.enc_dec else 1)
    # per-device token count under batch DP (batch may be replicated)
    dp = min(b, n_devices)
    tokens_local = d_tokens / dp

    if shape.kind == "train":
        # params bf16 read (fwd+bwd) + f32 master read/write + grads f32 r/w
        # + adam m,v read/write  ->  ~ (2+2)*2 + 4*2 + 4*2 + 8*2 = 40 B/param
        param_traffic = 40.0 * p_local
        act_c = 4.0 if run.remat == "none" else 2.5       # saved acts r/w
        act_traffic = layers * tokens_local * d * 2.0 * act_c
        logits_traffic = tokens_local * vp * 2.0 * 2.0
        hbm = param_traffic + act_traffic + logits_traffic
    elif shape.kind == "prefill":
        param_traffic = 2.0 * p_local
        act_traffic = layers * tokens_local * d * 2.0 * 2.0
        cache_local = _cache_bytes(cfg, shape, n_devices)
        hbm = param_traffic + act_traffic + cache_local   # write cache once
    else:  # decode
        n_active_local = matmul_params(cfg, active=True) / n_devices
        param_traffic = 2.0 * n_active_local
        cache_local = _cache_bytes(cfg, shape, n_devices)
        hbm = param_traffic + cache_local                 # read full cache
    return ModelCost(model_flops=flops,
                     model_flops_w_attn=flops + attn,
                     hbm_bytes_per_device=hbm)


def _cache_bytes(cfg: ArchConfig, shape: ShapeConfig, n_devices: int) -> float:
    """Per-device KV/SSM cache bytes (bf16 KV, f32 SSM state)."""
    b, t = shape.global_batch, shape.seq_len
    total = 0.0
    if cfg.family != "ssm":
        kv = cfg.n_layers * b * t * cfg.n_kv_heads * cfg.resolved_head_dim \
            * 2 * 2  # k+v, bf16
        if cfg.enc_dec:
            kv *= 1.5  # + cross-attention cache (enc len <= t)
        total += kv
    if cfg.family in ("ssm", "hybrid"):
        total += cfg.n_layers * b * cfg.d_inner * (cfg.ssm.d_state + 3) * 4.0
    # caches shard over batch (data) and length (model) when divisible
    return total / n_devices
