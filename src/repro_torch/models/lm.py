"""Decoder-only language model, dense, MoE, SSM and hybrid families:
training forward, prefill, decode.

The layer weights stay stacked along a leading (L, ...) dim, exactly the
reference's param tree, so snapshot keys and shapes match; the reference's
``lax.scan`` over that dim becomes a Python loop over ``p[i]`` slices.
Caches are the reference's ``{"kv": KVCache(k, v)}`` with k and v stacked
(L, B, S, K, hd) in bf16, and ``{"ssm": SSMCache(conv, h)}`` stacked
(L, B, d_conv-1, Di) and (L, B, Di, N) in f32; a hybrid carries both.
An MoE block's metrics (aux and z-losses, drop fraction) come back from
``forward_train`` as their mean over the layers, as in the reference.
"""
from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from typing import Any, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import (ACT, TensorSpec, constrain,
                                              current_rules, run_local,
                                              shards, stack_specs,
                                              use_rules)
from repro_torch.models import attention, layers, ssm
from repro_torch.models.attention import KVCache
from repro_torch.moe.moe import moe_apply, moe_specs


def cast_tree(tree, dtype):
    """Cast float leaves to the compute dtype before the layer loop.

    ``Tensor.to`` returns a tensor already in ``dtype`` unchanged, so a
    caller that serves many steps (the engine, the serve launcher) casts
    its params once and each call's cast costs nothing: in eager PyTorch
    a per-call cast of granite-3-2b's f32 layers would read 10.5 GB and
    write 5.3 GB per decode step, where XLA fuses it away."""
    def c(a):
        return a.to(dtype) if a.is_floating_point() else a
    return tu.tree_map(c, tree)


def gather_weights(lp: dict, run: RunConfig) -> dict:
    """FSDP gather-then-compute (RunConfig.fsdp_gather_weights)."""
    if not run.fsdp_gather_weights:
        return lp
    return tu.tree_map(lambda a: constrain(a, (None,) * a.ndim), lp)


# the matrix products ``remat="dots"`` keeps (``einsum``, ``matmul`` and
# ``linear`` lower to these), as the reference's ``checkpoint_dots``
# keeps every ``dot_general``
_DOTS = frozenset({torch.ops.aten.mm, torch.ops.aten.addmm,
                   torch.ops.aten.bmm, torch.ops.aten.baddbmm})


def _save_dots(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op.overloadpacket in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs.  ``remat`` != "none" recomputes each layer in the
    backward pass (``torch.utils.checkpoint``), keeping what
    ``remat_policy`` says.  The mesh knobs act on a cell built on a mesh
    and are inert elsewhere: ``logical_rules`` overrides entries of the
    sharding rule table, and ``fsdp_gather_weights`` (``gather_weights``)
    gathers each layer's FSDP-sharded weights whole before use."""
    remat: str = "full"              # none | full | dots
    block_kv: int = 1024
    ssm_chunk: int = 256
    capacity_factor: float = 1.25
    compute_dtype: Any = torch.bfloat16
    logical_rules: Optional[dict] = None   # sharding-rule overrides
    # FSDP semantics: gather each layer's (sharded) weights to replicated
    # right before use, rather than letting the sharded product pick its
    # own redistribution (partial sums of whole activations)
    fsdp_gather_weights: bool = False

    def remat_policy(self):
        """-> the ``context_fn`` each layer's ``checkpoint`` takes, or None
        for no remat: "full" saves nothing (every op of the layer runs
        again in the backward pass); "dots" saves the matrix products'
        outputs and recomputes the rest, as the reference's
        ``checkpoint_dots``."""
        if self.remat == "none":
            return None
        if self.remat == "dots":
            return functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots)
        return noop_context_fn


def recompute_under_rules(context_fn):
    """``context_fn`` (a ``checkpoint`` context function) whose recompute
    context also holds the sharding rules the forward ran under: the
    backward, where the recompute runs, may run on another thread (the
    card's autograd thread), which does not see the forward's."""
    def contexts():
        fwd, recompute = context_fn()
        rules = current_rules()
        if rules is None:
            return fwd, recompute
        return fwd, _both(recompute, use_rules(rules))
    return contexts


@contextlib.contextmanager
def _both(first, second):
    with first, second:
        yield


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ArchConfig) -> dict:
    out: dict = {"ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones")}
    if cfg.family == "ssm":
        out["ssm"] = ssm.ssm_specs(cfg)
        return out
    out["attn"] = attention.attn_specs(cfg)
    if cfg.family == "hybrid":
        out["ssm"] = ssm.ssm_specs(cfg)
        out["norm_attn"] = TensorSpec((cfg.d_model,), ("embed",), init="ones")
        out["norm_ssm"] = TensorSpec((cfg.d_model,), ("embed",), init="ones")
    out["ln2"] = TensorSpec((cfg.d_model,), ("embed",), init="ones")
    if cfg.is_moe:
        out["moe"] = moe_specs(cfg)
    else:
        out["mlp"] = layers.mlp_specs(cfg.d_model, cfg.d_ff)
    return out


def cache_specs(cfg: ArchConfig, batch: int, max_len: int) -> dict:
    out: dict = {}
    if cfg.family != "ssm":
        out["kv"] = attention.cache_specs(cfg, batch, max_len)
    if cfg.family in ("ssm", "hybrid"):
        out["ssm"] = ssm.ssm_cache_specs(cfg, batch)
    return out


def lm_specs(cfg: ArchConfig) -> dict:
    vp = cfg.padded_vocab()
    out = {
        "embed": TensorSpec((vp, cfg.d_model), ("vocab", "embed")),
        "layers": stack_specs(block_specs(cfg), cfg.n_layers),
        "final_norm": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = TensorSpec((cfg.d_model, vp), ("embed", "vocab"))
    return out


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def _mix(cfg: ArchConfig, p: dict, a: torch.Tensor,
         s: torch.Tensor) -> torch.Tensor:
    """The hybrid block's parallel heads: 0.5 (norm(attn) + norm(ssm))."""
    return 0.5 * (layers.rms_norm(a, p["norm_attn"], cfg.rms_eps)
                  + layers.rms_norm(s, p["norm_ssm"], cfg.rms_eps))


def _ffn(cfg: ArchConfig, run: RunConfig, p: dict, x: torch.Tensor):
    """x + the block's feed-forward (SwiGLU or MoE) of norm(x); -> (x,
    metrics): the MoE's, or none."""
    xn2 = layers.rms_norm(x, p["ln2"], cfg.rms_eps)
    if cfg.is_moe:
        y, metrics = moe_apply(p["moe"], xn2, cfg, run.capacity_factor)
        return x + y, metrics
    m = p["mlp"]
    return x + layers.swiglu(xn2, m["w_gate"], m["w_up"], m["w_down"]), {}


def _block_train(cfg: ArchConfig, run: RunConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True):
    """-> (x, the block's metrics)."""
    xn = layers.rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.family == "ssm":
        return x + ssm.ssm_train(p["ssm"], xn, cfg, run.ssm_chunk), {}
    a = attention.attn_train(p["attn"], xn, cfg, positions, causal=causal)
    if cfg.family == "hybrid":
        x = x + _mix(cfg, p, a,
                     ssm.ssm_train(p["ssm"], xn, cfg, run.ssm_chunk))
    else:
        x = x + a
    return _ffn(cfg, run, p, x)


def _block_decode(cfg: ArchConfig, run: RunConfig, p: dict, x: torch.Tensor,
                  cache: dict, index: torch.Tensor):
    new_cache = {}
    xn = layers.rms_norm(x, p["ln1"], cfg.rms_eps)
    if cfg.family == "ssm":
        y, new_cache["ssm"] = ssm.ssm_decode(p["ssm"], xn, cfg, cache["ssm"])
        return x + y, new_cache
    a, new_cache["kv"] = attention.attn_decode(p["attn"], xn, cfg,
                                               cache["kv"], index)
    if cfg.family == "hybrid":
        s, new_cache["ssm"] = ssm.ssm_decode(p["ssm"], xn, cfg, cache["ssm"])
        x = x + _mix(cfg, p, a, s)
    else:
        x = x + a
    return _ffn(cfg, run, p, x)[0], new_cache


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------
def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    table = params["embed"].to(dtype)
    if isinstance(table, DTensor):
        return _lookup_sharded(table, tokens)
    return table[tokens.long()]


def _lookup_sharded(table: DTensor, tokens: DTensor) -> DTensor:
    """The embedding lookup on a mesh: the table's rows split by its vocab
    rule (the rest gathered whole), each rank looks up the tokens of its
    batch shard that fall in its rows and zeros the rest; the output is a
    partial sum over the vocab's mesh dims, which one value and zeros
    make exact.  The local lookup is the plain one, forward and backward
    (DTensor's own ``index`` has no strategy for a split table's
    backward, nor on a 3-axis mesh)."""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):      # a plain batch: the same on
        tokens = DTensor.from_local(         # every rank
            tokens, mesh, (Replicate(),) * mesh.ndim, run_check=False)
    table = constrain(table, ("vocab", None))
    tokens = constrain(tokens, ("act_batch", None))
    pt, pk = tuple(table.placements), tuple(tokens.placements)
    vocab_dims = [i for i, p in enumerate(pt) if p.is_shard()]
    if any(pk[i].is_shard() for i in vocab_dims):
        raise ValueError(f"embedding: tokens at {pk} split a mesh dim the "
                         f"table's vocab {pt} splits")
    coord, first = mesh.get_coordinate(), 0
    for i in vocab_dims:
        first = first * mesh.size(i) + coord[i]
    first *= table.shape[0] // shards(mesh, pt)

    def look(t, ids):
        local = ids.long() - first
        hit = (local >= 0) & (local < t.shape[0])
        return t[local.clamp(0, t.shape[0] - 1)] * hit[..., None].to(t.dtype)

    out = tuple(Partial() if i in vocab_dims else p
                for i, p in enumerate(pk))
    grad = tuple(Partial() if pk[i].is_shard() else p
                 for i, p in enumerate(pt))
    return run_local(look, None, (pt, pk), out, table, tokens,
                     grad_placements=(grad, pk))


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype))
    return x @ params["lm_head"].to(x.dtype)


def forward_train(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  run: RunConfig = RunConfig(), *, causal: bool = True):
    """tokens: (B, T) -> (logits (B,T,Vp), metrics)."""
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(b, t)
    layer_params = cast_tree(params["layers"], run.compute_dtype)

    def body(x, lp):
        lp = gather_weights(lp, run)
        x, metrics = _block_train(cfg, run, lp, x, positions, causal)
        return constrain(x, ACT), metrics

    policy = run.remat_policy()
    per_layer = []
    for i in range(cfg.n_layers):
        lp = tu.tree_map(lambda a: a[i], layer_params)
        if policy is not None:
            x, metrics = checkpoint(
                body, x, lp, use_reentrant=False,
                context_fn=recompute_under_rules(policy))
        else:
            x, metrics = body(x, lp)
        per_layer.append(metrics)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    metrics = {k: torch.stack([m[k] for m in per_layer]).mean()
               for k in per_layer[0]}
    logits = constrain(unembed(params, cfg, x),
                       ("act_batch", "act_seq", "act_vocab"))
    return logits, metrics


def prefill(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
            max_len: int, run: RunConfig = RunConfig()):
    """Build caches for ``tokens`` and return last-position logits.

    Returns (logits (B, Vp), caches).  Cache buffers are allocated at
    ``max_len`` so decode can continue in place.  On the card, every
    layer's attention is one flash-attention launch and every layer's
    selective scan one ``ssm_scan`` launch.
    """
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(b, t)
    layer_params = cast_tree(params["layers"], run.compute_dtype)
    per_layer = []
    for i in range(cfg.n_layers):
        lp = gather_weights(tu.tree_map(lambda a: a[i], layer_params), run)
        new_cache = {}
        xn = layers.rms_norm(x, lp["ln1"], cfg.rms_eps)
        if cfg.family == "ssm":
            y, new_cache["ssm"] = ssm.ssm_train(lp["ssm"], xn, cfg,
                                                run.ssm_chunk, True)
            x = x + y
        else:
            a, kv = attention.attn_prefill(lp["attn"], xn, cfg, positions)
            new_cache["kv"] = pad_cache(kv, max_len)
            if cfg.family == "hybrid":
                s, new_cache["ssm"] = ssm.ssm_train(lp["ssm"], xn, cfg,
                                                    run.ssm_chunk, True)
                x = x + _mix(cfg, lp, a, s)
            else:
                x = x + a
            x, _ = _ffn(cfg, run, lp, x)
        x = constrain(x, ACT)
        per_layer.append(new_cache)
    x = layers.rms_norm(x[:, -1:], params["final_norm"], cfg.rms_eps)
    logits = unembed(params, cfg, x)[:, 0]
    return logits, tu.tree_map(lambda *ls: torch.stack(ls), *per_layer)


def pad_cache(kv: KVCache, max_len: int) -> KVCache:
    """(B, T, K, hd) -> (B, max_len, K, hd) bf16, zeros past T: the cache
    is bf16 whatever the compute dtype, as in the reference."""
    def pad(a):
        out = a.new_zeros((a.shape[0], max_len) + tuple(a.shape[2:]),
                          dtype=torch.bfloat16)
        out[:, :a.shape[1]] = a
        return out
    return KVCache(pad(kv.k), pad(kv.v))


def decode_step(params: dict, cfg: ArchConfig, caches: dict,
                tokens: torch.Tensor, index, run: RunConfig = RunConfig()):
    """One-token decode.  tokens: (B, 1); index: scalar current length, or
    (B,) per-sequence lengths.  Returns (logits (B, 1, Vp), caches); the
    cache tensors are updated in place and returned."""
    x = constrain(embed_tokens(params, cfg, tokens, run.compute_dtype), ACT)
    index = torch.as_tensor(index, dtype=torch.int32, device=x.device)
    layer_params = cast_tree(params["layers"], run.compute_dtype)
    for i in range(cfg.n_layers):
        lp = tu.tree_map(lambda a: a[i], layer_params)
        cache = tu.tree_map(lambda c: c[i], caches)   # views of layer i
        x, new = _block_decode(cfg, run, lp, x, cache, index)
        x = constrain(x, ACT)
        if "ssm" in new:    # the KV rows were written in place already
            for dst, src in zip(cache["ssm"], new["ssm"]):
                dst.copy_(src)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), caches
