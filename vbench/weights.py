"""Weights made by the benchmark from ``--seed``, on the device, in one
large draw: the program and the reference are handed the same values.

A leaf's values depend on its key (the program's snapshot key, such as
``.params['layers']['attn']['wq']``) and shape only, by these rules: norm
scales, ``D`` and ``dt_bias`` are ones, biases (``conv_b``, ``bq``, ``bk``,
``bv``) zeros, ``A_log`` is log(1 .. d_state) along its last dim (Mamba's
initialisation), and every other leaf (the matrices and the embedding) is
drawn from N(0, 0.02^2).  The draws follow the keys' sorted order, so one
seed gives the same tree whichever way it is walked.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

STD = 0.02
ONES = {"ln1", "ln2", "final_norm", "norm_attn", "norm_ssm", "D", "dt_bias"}
ZEROS = {"conv_b", "bq", "bk", "bv"}


def leaf_name(key: str) -> str:
    """The innermost name of a snapshot key: ``...['attn']['wq']`` -> wq."""
    names = re.findall(r"\['([^']+)'\]", key)
    return names[-1] if names else key.strip(".")


def rule(key: str) -> str:
    name = leaf_name(key)
    if name in ONES:
        return "ones"
    if name in ZEROS:
        return "zeros"
    if name == "A_log":
        return "slow_decay"
    return "normal"


def make(shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{key: tensor} for ``shapes`` ({key: shape}), every normal leaf a
    slice of one draw from a generator on ``device`` seeded by ``seed``."""
    keys = sorted(shapes)
    normal = [k for k in keys if rule(k) == "normal"]
    total = sum(math.prod(shapes[k]) for k in normal)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=dtype).mul_(STD)
    out, off = {}, 0
    for k in keys:
        shape, kind = shapes[k], rule(k)
        if kind == "normal":
            n = math.prod(shape)
            out[k] = flat[off:off + n].view(shape)
            off += n
        elif kind == "ones":
            out[k] = torch.ones(shape, dtype=dtype, device=device)
        elif kind == "zeros":
            out[k] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            a = torch.arange(1, shape[-1] + 1, dtype=torch.float32,
                             device=device)
            out[k] = torch.log(a).to(dtype).expand(shape).contiguous()
    return out
