"""Family ``hybrid``: parallel attention and Mamba heads in every layer
(hymba-1.5b).  Each of the L layers is

    n = norm1(x)
    h = x + (norm_a(attn(n)) + norm_s(mamba(n))) / 2
    x' = h + swiglu(norm2(h))

with RMS norms, rotary causal attention and Mamba 1's mixer
(``vbench.reference.model``); the rest is ``dense``'s.
"""
from __future__ import annotations

import torch

from vbench import costs
from vbench.reference.families import dense
from vbench.reference.model import (attention, embed, layer, mamba, rms_norm,
                                    swiglu)
from vbench.reference.precision import Precision

PROGRAM_FAMILY = "hybrid"
ONES = frozenset({"norm_attn", "norm_ssm"})
ZEROS: frozenset = frozenset()
TINY = dict(dense.TINY, mamba_d_state=4, mamba_dt_rank=8)


def block(c: dict, w: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    n = rms_norm(x, layer(w, "layers.ln1", i), eps)
    a = attention(c, w, i, n, prec)
    s = mamba(c, w, i, n, prec)
    x = x + 0.5 * (rms_norm(a, layer(w, "layers.norm_attn", i), eps)
                   + rms_norm(s, layer(w, "layers.norm_ssm", i), eps))
    return x + swiglu(w, i, rms_norm(x, layer(w, "layers.ln2", i), eps), prec)


def hidden(c: dict, w: dict, tokens: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    x = embed(w, tokens)
    for i in range(c["num_hidden_layers"]):
        x = block(c, w, i, x, prec)
    return rms_norm(x, w["final_norm"].float(), c["rms_norm_eps"])


def matmul_params(c: dict) -> int:
    return dense.matmul_params(c) \
        + c["num_hidden_layers"] * costs.mamba_params(c)


attention_layers = dense.attention_layers


def arch_fields(c: dict) -> dict:
    return dict(dense.arch_fields(c),
                ssm=dict(d_state=c["mamba_d_state"], d_conv=c["mamba_d_conv"],
                         expand=c["mamba_expand"], dt_rank=c["mamba_dt_rank"]))
