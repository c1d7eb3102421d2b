"""Tensor specs and seeded initialisation (``repro.distributed.sharding``).

The mesh-free part of the reference: ``TensorSpec`` (shape, logical axes,
dtype, init rule), ``stack_specs``, ``init_tree``, ``abstract_tree`` (a
spec tree as tensors on the ``meta`` device, the counterpart of the
reference's ``ShapeDtypeStruct`` trees) and ``param_bytes``.

The reference's logical-axis resolver has no counterpart: on one card
every tensor is whole, so there is no mesh to resolve ``ShardingRules``
against, no rule table for ``use_rules``/``current_rules`` to install,
and nothing for ``constrain`` to bind (the reference's ``constrain`` is
the identity outside a mesh, which is what the port's model code does
by not calling it).  ``abstract_tree`` takes no rules for that reason.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tu


@dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype + logical axes for one tensor."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | slow_decay (A_log)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


def init_tree(spec_tree, generator: torch.Generator, *, device,
              scale: float = 0.02):
    """TensorSpec tree -> concrete tensors on ``device``.

    Leaves draw from ``generator`` one after another in flatten order, with
    the reference's std rule: ``min(scale, 1/sqrt(fan_in))``, fan_in the
    leading dim of a matrix (the last dim of a vector).  ``generator`` must
    live on ``device``.  The numbers differ from ``jax.random``'s; parity
    tests carry JAX-initialised state across with ``repro_torch.convert``."""
    def mk(s: TensorSpec):
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=s.dtype, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=s.dtype, device=device)
        if s.init == "slow_decay":   # mamba A_log init: log(1..d_state)
            a = torch.arange(1, s.shape[-1] + 1, dtype=s.dtype, device=device)
            return torch.log(a.expand(s.shape).contiguous())
        fan_in = s.shape[0] if len(s.shape) > 1 else max(s.shape[-1], 1)
        std = min(scale, (1.0 / max(fan_in, 1)) ** 0.5)
        # scaled in place: a leaf costs one buffer of its size, not two
        return torch.randn(s.shape, dtype=s.dtype, device=device,
                           generator=generator).mul_(std)
    return tu.tree_map(mk, spec_tree)


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dim (e.g. layers) to every spec."""
    def st(s: TensorSpec):
        return TensorSpec((n,) + s.shape, (axis_name,) + s.axes, s.dtype, s.init)
    return tu.tree_map(st, spec_tree)


def abstract_tree(spec_tree):
    """TensorSpec tree -> tensors of the same shapes and dtypes on the
    ``meta`` device: no storage, so a full-width cell's state costs
    nothing to build and a step run on it only traces."""
    return tu.tree_map(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
        spec_tree)


def param_bytes(spec_tree) -> int:
    """Bytes of every tensor a spec tree describes."""
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for s in tu.leaves(spec_tree))
