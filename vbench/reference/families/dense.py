"""Family ``dense``: decoder-only GQA (granite-3-2b).  Each of the L
layers is

    h = x + attn(norm1(x))
    x' = h + swiglu(norm2(h))

with RMS norms and rotary causal attention (``vbench.reference.model``).
"""
from __future__ import annotations

import torch

from vbench import costs
from vbench.reference.model import (attention, embed, layer, rms_norm,
                                    swiglu)
from vbench.reference.precision import Precision

PROGRAM_FAMILY = "dense"
ONES: frozenset = frozenset()
ZEROS: frozenset = frozenset()
TINY = dict(hidden_size=128, num_attention_heads=4, num_key_value_heads=2,
            head_dim=32, intermediate_size=256, vocab_size=256,
            num_hidden_layers=2)


def block(c: dict, w: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    x = x + attention(c, w, i, rms_norm(x, layer(w, "layers.ln1", i), eps),
                      prec)
    return x + swiglu(w, i, rms_norm(x, layer(w, "layers.ln2", i), eps), prec)


def hidden(c: dict, w: dict, tokens: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    x = embed(w, tokens)
    for i in range(c["num_hidden_layers"]):
        x = block(c, w, i, x, prec)
    return rms_norm(x, w["final_norm"].float(), c["rms_norm_eps"])


def matmul_params(c: dict) -> int:
    """Every layer's attention and SwiGLU, and the head (a tied table
    counts once, as the head)."""
    layer_params = costs.attention_params(c) \
        + costs.swiglu_params(c, c["intermediate_size"])
    return c["num_hidden_layers"] * layer_params \
        + c["hidden_size"] * c["vocab_size"]


def attention_layers(c: dict) -> int:
    return c["num_hidden_layers"]


def arch_fields(c: dict) -> dict:
    return dict(n_layers=c["num_hidden_layers"], d_model=c["hidden_size"],
                n_heads=c["num_attention_heads"],
                n_kv_heads=c["num_key_value_heads"],
                d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
                head_dim=costs.head_dim(c), rope_theta=c["rope_theta"],
                rms_eps=c["rms_norm_eps"],
                tie_embeddings=c["tie_word_embeddings"],
                qkv_bias=c["attention_bias"],
                window=c.get("sliding_window", 0))
