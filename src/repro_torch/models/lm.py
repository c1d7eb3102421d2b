"""Decoder-only language model, dense family (training path).

The layer weights stay stacked along a leading (L, ...) dim, exactly the
reference's param tree, so snapshot keys and shapes match; the reference's
``lax.scan`` over that dim becomes a Python loop over ``p[i]`` slices.
The SSM, hybrid and MoE blocks, prefill and decode come with later slices
of the port and raise here.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import TensorSpec, stack_specs
from repro_torch.models import attention, layers


def cast_tree(tree, dtype):
    """Cast float leaves to the compute dtype before the layer loop."""
    def c(a):
        return a.to(dtype) if a.is_floating_point() else a
    return tu.tree_map(c, tree)


@dataclass(frozen=True)
class RunConfig:
    """Execution knobs.  ``remat`` != "none" recomputes each layer in the
    backward pass (``torch.utils.checkpoint``).  The reference's MoE and
    mesh knobs come with the slices that use them."""
    remat: str = "full"              # none | full | dots
    block_kv: int = 1024
    ssm_chunk: int = 256
    compute_dtype: Any = torch.bfloat16


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family in ("ssm", "hybrid") or cfg.is_moe:
        raise NotImplementedError(f"{cfg.family} blocks are not yet ported "
                                  "to repro_torch")


# ---------------------------------------------------------------------------
# Param specs
# ---------------------------------------------------------------------------
def block_specs(cfg: ArchConfig) -> dict:
    _require_dense(cfg)
    return {"ln1": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
            "attn": attention.attn_specs(cfg),
            "ln2": TensorSpec((cfg.d_model,), ("embed",), init="ones"),
            "mlp": layers.mlp_specs(cfg.d_model, cfg.d_ff)}


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
def _block_train(cfg: ArchConfig, run: RunConfig, p: dict, x: torch.Tensor,
                 positions: torch.Tensor, causal: bool = True):
    _require_dense(cfg)
    xn = layers.rms_norm(x, p["ln1"], cfg.rms_eps)
    x = x + attention.attn_train(p["attn"], xn, cfg, positions, causal=causal)
    xn2 = layers.rms_norm(x, p["ln2"], cfg.rms_eps)
    m = p["mlp"]
    return x + layers.swiglu(xn2, m["w_gate"], m["w_up"], m["w_down"])


# ---------------------------------------------------------------------------
# Model entry points
# ---------------------------------------------------------------------------
def embed_tokens(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                 dtype) -> torch.Tensor:
    return params["embed"].to(dtype)[tokens.long()]


def unembed(params: dict, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("btd,vd->btv", x, params["embed"].to(x.dtype))
    return x @ params["lm_head"].to(x.dtype)


def forward_train(params: dict, cfg: ArchConfig, tokens: torch.Tensor,
                  run: RunConfig = RunConfig(), *, causal: bool = True):
    """tokens: (B, T) -> (logits (B,T,Vp), metrics)."""
    x = embed_tokens(params, cfg, tokens, run.compute_dtype)
    b, t = x.shape[:2]
    positions = torch.arange(t, dtype=torch.int32,
                             device=x.device).expand(b, t)
    layer_params = cast_tree(params["layers"], run.compute_dtype)

    def body(x, lp):
        return _block_train(cfg, run, lp, x, positions, causal)

    for i in range(cfg.n_layers):
        lp = tu.tree_map(lambda a: a[i], layer_params)
        if run.remat != "none":
            x = checkpoint(body, x, lp, use_reentrant=False)
        else:
            x = body(x, lp)
    x = layers.rms_norm(x, params["final_norm"], cfg.rms_eps)
    return unembed(params, cfg, x), {}
