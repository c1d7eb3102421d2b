"""Tensor specs, seeded initialisation and the logical-axis sharding
resolver (``repro.distributed.sharding``).

Every tensor (params, optimizer state, activations, caches) carries
*logical* axis names.  A rule table maps logical axes to mesh axes; the
resolver gives each tensor a spec, sharding a dim only when its size is
divisible by the mesh-axis extent (else it replicates and logs: e.g.
qwen2's 12 heads or 8 KV heads on a model=16 axis), and a mesh axis at
most once.  ``spec_for`` returns the reference's ``PartitionSpec`` as a
tuple with one tuple of mesh-axis names per dim (``()``: replicated);
``placements_for`` turns it into one DTensor placement per mesh dim
(``Shard(d)`` on every mesh dim that shards tensor dim ``d``, else
``Replicate()``).

``init_tree`` and ``abstract_tree`` take the rules too: a leaf is then a
DTensor on the rules' ``DeviceMesh`` (on ``meta``, a DTensor of shapes
only, the counterpart of a ``ShapeDtypeStruct`` with a sharding).  Model
code calls ``constrain(x, axes)``; inside ``use_rules`` it redistributes a
DTensor to the resolved placements, and outside any context (or on a
plain tensor) it is the identity, so model code stays mesh-agnostic.
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import logging
import math
import re
import threading
from dataclasses import dataclass
from typing import Any, Optional, Sequence, Tuple, Union

import torch
from torch.distributed.tensor import (DTensor, Placement, Replicate, Shard,
                                      distribute_tensor)
from torch.distributed.tensor.experimental import (implicit_replication,
                                                   local_map)

from repro_torch import tree as tu

logger = logging.getLogger("repro_torch.sharding")
_TLS = threading.local()     # the active rules

MeshAxes = Union[str, Tuple[str, ...], None]


@dataclass(frozen=True)
class TensorSpec:
    """Shape + dtype + logical axes for one tensor."""
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: Any = torch.float32
    init: str = "normal"          # normal | zeros | ones | slow_decay (A_log)

    def __post_init__(self):
        assert len(self.shape) == len(self.axes), (self.shape, self.axes)


# Default production rule table (DESIGN.md §5).
#   embed   -> FSDP over the data axis (ZeRO-3 style weight sharding)
#   heads/ff/vocab/experts/inner -> tensor parallel over the model axis
#   batch   -> data parallel over (pod, data)
#   cache_len -> model axis (decode KV caches whose head count doesn't divide)
DEFAULT_RULES: dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "embed": "data",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "ff": "model",
    "vocab": "model",
    "experts": "model",
    "expert_ff": None,
    "inner": "model",            # mamba d_inner
    "state": None,
    "seq": None,
    "cache_len": "model",
    "cache_heads": "model",
    "conv": None,
    "dt_rank": None,
    # --- activation logical axes (distinct from param axes: the FSDP
    # "embed" rule must NOT leak onto activations — GSPMD would otherwise
    # shard activations on embed over the data axis and replicate batch,
    # turning every matmul into a giant partial-sum all-reduce) ---
    "act_batch": ("pod", "data"),
    "act_seq": None,
    "act_embed": None,
    "act_heads": "model",
    "act_ff": "model",
    "act_vocab": "model",
    "act_inner": "model",
}

Spec = Tuple[Tuple[str, ...], ...]
# an activation (B, T, D) between sublayers: the batch split, the rest
# whole (a sublayer's pending partial sums are reduced to it before they
# meet the residual stream)
ACT = ("act_batch", "act_seq", "act_embed")


@dataclass(frozen=True)
class AbstractMesh:
    """Mesh-axis names and extents with no devices behind them (the
    reference's ``jax.sharding.AbstractMesh``): enough for ``spec_for``
    and ``placements_for``, which read only ``shape`` and
    ``mesh_dim_names``, as a ``DeviceMesh`` has them."""
    shape: Tuple[int, ...]
    mesh_dim_names: Tuple[str, ...]


@dataclass
class ShardingRules:
    mesh: Any                    # DeviceMesh (or AbstractMesh)
    rules: dict[str, MeshAxes] = dataclasses.field(
        default_factory=lambda: dict(DEFAULT_RULES))
    log_replications: bool = True

    def extent(self, axis: str) -> int:
        """The size of the mesh axis named ``axis``."""
        return int(self.mesh.shape[self.mesh.mesh_dim_names.index(axis)])

    def _mesh_axes_for(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        target = self.rules.get(logical)
        if target is None:
            return ()
        if isinstance(target, str):
            target = (target,)
        return tuple(a for a in target if a in self.mesh.mesh_dim_names)

    def spec_for(self, spec_or_axes, shape=None) -> Spec:
        """The spec of a TensorSpec (or (axes, shape) pair): per dim the
        mesh axes that shard it, ``()`` for a replicated dim."""
        if isinstance(spec_or_axes, TensorSpec):
            axes, shape = spec_or_axes.axes, spec_or_axes.shape
        else:
            axes = spec_or_axes
        assert shape is not None
        parts: list = []
        used: set[str] = set()
        for dim, logical in zip(shape, axes):
            mesh_axes = self._mesh_axes_for(logical)
            # a mesh axis may appear at most once in a spec
            mesh_axes = tuple(a for a in mesh_axes if a not in used)
            extent = math.prod(self.extent(a) for a in mesh_axes)
            if mesh_axes and dim % extent == 0 and dim > 0:
                parts.append(mesh_axes)
                used.update(mesh_axes)
            else:
                if mesh_axes and self.log_replications:
                    logger.info(
                        "replicating dim %d (logical %r) on mesh axes %r "
                        "(not divisible by %d)", dim, logical, mesh_axes, extent)
                parts.append(())
        return tuple(parts)

    def placements_for(self, spec: Spec) -> tuple:
        """One DTensor placement per mesh dim: ``Shard(d)`` where tensor
        dim ``d`` is sharded over that mesh axis, else ``Replicate()``.
        A dim sharded over several mesh axes is split over them in the
        mesh's order (major to minor), as the rule tables list them."""
        where = {a: d for d, axes in enumerate(spec) for a in axes}
        return tuple(Shard(where[a]) if a in where else Replicate()
                     for a in self.mesh.mesh_dim_names)

    def tensor_placements(self, spec_or_axes, shape=None) -> tuple:
        return self.placements_for(self.spec_for(spec_or_axes, shape))

    def tree_placements(self, spec_tree) -> Any:
        """Map a tree of TensorSpec to their placements."""
        return tu.tree_map(self.tensor_placements, spec_tree)

    def distribute(self, x: torch.Tensor, spec: "TensorSpec") -> DTensor:
        """A whole tensor as a DTensor at ``spec``'s placements: every
        rank keeps its shard of the same values."""
        return distribute_tensor(x, self.mesh, self.tensor_placements(spec))

    def local_shape(self, spec: "TensorSpec") -> Tuple[int, ...]:
        """The shape of one device's shard of ``spec``."""
        shape = list(spec.shape)
        for d, axes in enumerate(self.spec_for(spec)):
            shape[d] //= math.prod(self.extent(a) for a in axes)
        return tuple(shape)


def init_tree(spec_tree, generator: torch.Generator, *, device,
              scale: float = 0.02, rules: Optional[ShardingRules] = None):
    """TensorSpec tree -> concrete tensors on ``device``.

    Leaves draw from ``generator`` one after another in flatten order, with
    the reference's std rule: ``min(scale, 1/sqrt(fan_in))``, fan_in the
    leading dim of a matrix (the last dim of a vector).  ``generator`` must
    live on ``device``.  The numbers differ from ``jax.random``'s; parity
    tests carry JAX-initialised state across with ``repro_torch.convert``.

    With ``rules`` each leaf is drawn whole, as without, and then
    distributed to its placements, so a sharded tree holds the unsharded
    tree's values (small sizes only: every rank draws every leaf)."""
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
    if rules is None:
        return tu.tree_map(mk, spec_tree)
    return tu.tree_map(lambda s: rules.distribute(mk(s), s), spec_tree)


def stack_specs(spec_tree, n: int, axis_name: Optional[str] = None):
    """Prepend a stacking dim (e.g. layers) to every spec."""
    def st(s: TensorSpec):
        return TensorSpec((n,) + s.shape, (axis_name,) + s.axes, s.dtype, s.init)
    return tu.tree_map(st, spec_tree)


def abstract_tree(spec_tree, rules: Optional[ShardingRules] = None):
    """TensorSpec tree -> tensors of the same shapes and dtypes on the
    ``meta`` device: no storage, so a full-width cell's state costs
    nothing to build and a step run on it only traces.  With ``rules``
    each leaf is a meta DTensor of the global shape at its resolved
    placements, each rank's local tensor its shard's shape."""
    if rules is None:
        return tu.tree_map(
            lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
            spec_tree)

    def mk(s: TensorSpec):
        whole = torch.empty(s.shape, dtype=s.dtype, device="meta")
        local = torch.empty(rules.local_shape(s), dtype=s.dtype,
                            device="meta")
        return DTensor.from_local(local, rules.mesh,
                                  rules.tensor_placements(s),
                                  run_check=False, shape=whole.shape,
                                  stride=whole.stride())
    return tu.tree_map(mk, spec_tree)


def param_bytes(spec_tree, rules: Optional[ShardingRules] = None) -> int:
    """Bytes of every tensor a spec tree describes; with ``rules``, of
    one device's shards of them."""
    shape = (lambda s: s.shape) if rules is None else rules.local_shape
    return sum(math.prod(shape(s)) * s.dtype.itemsize
               for s in tu.leaves(spec_tree))


def shards(mesh, placements) -> int:
    """How many distinct shards a DTensor at ``placements`` has: the
    product of the extents of the mesh dims that shard it (the ranks along
    a replicated dim hold, and compute, the same)."""
    return math.prod(mesh.size(i) for i, p in enumerate(placements)
                     if p.is_shard())


def run_local(fn, counter, in_placements, out_placements, *args,
              grad_placements=None, products: bool = False):
    """``fn`` on each rank's local shards of the DTensors ``args``
    (``local_map``, inputs taken at ``in_placements`` as they are, never
    redistributed); -> DTensors at ``out_placements``.  The inputs'
    gradients come back at ``grad_placements`` (default: the inputs' own
    placements; an input replicated over a mesh dim that splits what it
    is used with gets a partial gradient there).

    The one local call stands for every distinct shard of its inputs,
    ``n`` of them, and a sharded trace counts the whole call's operations
    as an unsharded one does.  With ``products`` (``fn`` holds matrix
    products ``FlopCounterMode`` counts) ``fn`` runs as a module named
    ``LocalShards{n}``, under which the counter files them, forward and
    backward, for ``flop_analysis`` to scale by ``n``.  Only a call whose
    output is a single tensor may say so: the counter takes the module's
    backward to run from its output's gradient to its inputs', and a call
    with several outputs would have other nodes run in between.
    ``counter``, if not None, is a kernel whose meta route adds each
    call's operations to its ``meta_flops``, scaled here on ``meta``."""
    mesh = args[0].device_mesh
    for x, want in zip(args, in_placements):
        if tuple(x.placements) != tuple(want):
            raise ValueError(f"run_local: input at {x.placements}, the "
                             f"kernel takes {want}")
    # local_map reads a tuple as one entry per output, a list as the
    # placements of a single output
    outs = list(out_placements) if isinstance(out_placements[0], Placement) \
        else tuple(list(p) for p in out_placements)
    n = shards(mesh, in_placements[0])
    grads = None if grad_placements is None else \
        tuple(list(p) for p in grad_placements)
    before = counter.meta_flops if counter is not None else 0
    out = local_map(_local_module(n, fn) if products else fn,
                    out_placements=outs,
                    in_placements=tuple(list(p) for p in in_placements),
                    in_grad_placements=grads, device_mesh=mesh)(*args)
    if counter is not None and args[0].device.type == "meta":
        counter.meta_flops = before + (counter.meta_flops - before) * n
    return out


LOCAL_SHARDS = re.compile(r"(?:^|\.)LocalShards(\d+)$")


@functools.lru_cache(maxsize=None)
def _local_class(n: int) -> type:
    return type(f"LocalShards{n}", (torch.nn.Module,),
                {"forward": lambda self, *a: self.fn(*a)})


def _local_module(n: int, fn) -> torch.nn.Module:
    mod = _local_class(n)()
    mod.fn = fn
    return mod


# ---------------------------------------------------------------------------
# Activation-constraint context: model code calls ``constrain(x, axes)`` with
# logical axis names; the active ShardingRules (set around each step of a
# cell built on a mesh) resolve them to the current mesh.  Outside any
# context constrain() is the identity, keeping model code mesh-agnostic.
# ---------------------------------------------------------------------------
@contextlib.contextmanager
def use_rules(rules: Optional[ShardingRules]):
    """Install ``rules`` for ``constrain``.  Inside, a plain tensor that
    meets a DTensor counts as replicated: the positions, masks and
    constants the model code makes are the same on every rank."""
    prev = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        with implicit_replication() if rules is not None \
                else contextlib.nullcontext():
            yield
    finally:
        _TLS.rules = prev


def current_rules() -> Optional[ShardingRules]:
    return getattr(_TLS, "rules", None)


def constrain(x, axes: Sequence[Optional[str]]):
    """Redistribute the DTensor ``x`` to the placements the active rules
    give ``axes`` (the reference's ``with_sharding_constraint``); the
    identity on a plain tensor or outside ``use_rules``."""
    rules = current_rules()
    if rules is None or not isinstance(x, DTensor):
        return x
    placements = rules.tensor_placements(tuple(axes), x.shape)
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(rules.mesh, placements)
