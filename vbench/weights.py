"""Weights made by the benchmark from ``--seed``, on the device, in one
large draw: the program and the reference are handed the same values.

A leaf's values depend on its key (the program's snapshot key, such as
``.params['layers']['attn']['wq']``), its shape and the configuration's
family only, by these rules: the norm scales every family has (``ln1``,
``ln2``, ``final_norm``) and Mamba's ``D`` and ``dt_bias`` are ones, the
attention and conv biases (``bq``, ``bk``, ``bv``, ``conv_b``) zeros, as
are the leaves the family's file names in its ``ONES`` (ones) and
``ZEROS`` (zeros; ``reference/families/<family>.py``); ``A_log`` is log(1 .. d_state)
along its last dim (Mamba's initialisation), and every other leaf (the
matrices and the embedding) is drawn from N(0, 0.02^2).  The draws follow
the keys' sorted order, so one seed gives the same tree whichever way it
is walked.
"""
from __future__ import annotations

import math
import re
from typing import Dict, Tuple

import torch

from vbench.reference import families

STD = 0.02
ONES = frozenset({"ln1", "ln2", "final_norm", "D", "dt_bias"})
ZEROS = frozenset({"conv_b", "bq", "bk", "bv"})


def leaf_name(key: str) -> str:
    """The innermost name of a snapshot key: ``...['attn']['wq']`` -> wq."""
    names = re.findall(r"\['([^']+)'\]", key)
    return names[-1] if names else key.strip(".")


def rule(key: str, c: dict) -> str:
    """How leaf ``key`` of configuration ``c`` is made."""
    name, fam = leaf_name(key), families.of(c)
    if name in ONES or name in fam.ONES:
        return "ones"
    if name in ZEROS or name in fam.ZEROS:
        return "zeros"
    if name == "A_log":
        return "slow_decay"
    return "normal"


def make(c: dict, shapes: Dict[str, Tuple[int, ...]], seed: int, device,
         dtype: torch.dtype) -> Dict[str, torch.Tensor]:
    """{key: tensor} for ``shapes`` ({key: shape}) of configuration ``c``,
    every normal leaf a slice of one draw from a generator on ``device``
    seeded by ``seed``."""
    keys = sorted(shapes)
    kinds = {k: rule(k, c) for k in keys}
    normal = [k for k in keys if kinds[k] == "normal"]
    total = sum(math.prod(shapes[k]) for k in normal)
    gen = torch.Generator(device=device).manual_seed(seed % 2**63)
    flat = torch.randn(total, generator=gen, device=device,
                       dtype=dtype).mul_(STD)
    out, off = {}, 0
    for k in keys:
        shape, kind = shapes[k], kinds[k]
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
