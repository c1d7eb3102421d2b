"""Tensor specs and seeded initialisation (``repro.distributed.sharding``).

Only the mesh-free part of the reference lives here: ``TensorSpec`` (shape,
logical axes, dtype, init rule), ``stack_specs`` and ``init_tree``.  The
logical-axis → mesh resolver and ``constrain`` wait for the port's
multi-card slice; on one card every tensor is whole.
"""
from __future__ import annotations

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
