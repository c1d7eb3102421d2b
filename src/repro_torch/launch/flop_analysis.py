"""Roofline terms of one cell on one card or a mesh of them (the
counterpart of ``repro/launch/hlo_analysis.py``).

The reference parses XLA's artifacts: matmul FLOPs from the lowered
StableHLO (trip-count aware, so remat duplicates show), collective bytes
from the compiled HLO, and the memory analysis of the compiled module.
The port has no HLO, so it counts what eager PyTorch runs:

* FLOPs: ``traced_flops`` runs the step under
  ``torch.utils.flop_counter.FlopCounterMode``, which counts every matrix
  product (and convolution) as it executes, forward, backward and the
  recompute of a checkpointed layer alike.  On the meta device the
  flash-attention and selective-scan kernels compute nothing; their meta
  routes add each call's operations from the formula in the kernel's
  module (``flops``), and ``traced_ops`` adds those in, by the peak they
  run at: the scan's float32 operations on the CUDA cores, everything
  else at the bf16 tensor-core peak (as the reference charges all its
  HLO FLOPs).  A cell on a mesh counts the same global FLOPs:
  ``FlopCounterMode`` sees each DTensor op at its global shapes, once,
  and a kernel run on local shards scales its count to the shards
  (``sharding.run_local``); the reference's count is the pre-SPMD global
  one too, which it divides evenly over the devices.
* One device's share: ``traced`` runs the step under ``traced_ops`` and,
  beneath it, a dispatch mode that sees the ops one device runs on its
  local shards: their FLOPs (what ``compute_s`` charges; a product left
  replicated over some mesh dims is counted as often as each device
  repeats it) and every ``_c10d_functional`` collective DTensor issues,
  with its output bytes and its group (the counterpart of
  ``parse_collectives``), the reference's wire factor turning those into
  bytes each device sends; ``CollectiveStats.seconds()`` charges each at
  its group's link rate (``mesh.link_bw``).
* Bytes: ``memory_dict`` takes the argument, output and cache trees'
  bytes from their specs (``param_bytes``; on a mesh, one device's
  shards) and the activations from the cost model's inventory (on a
  mesh, divided as "act_batch" divides the batch), in the reference's
  keys.
* ``Roofline`` keeps the reference's fields, properties and
  ``summary()`` keys, against one H100's peak rates (``mesh``); the
  summary's ``hlo_flops_per_device`` holds one device's traced count,
  and ``fp32_flops_per_device`` the part of it ``compute_s`` charges at the
  float32 peak.  Without ``coll`` (one card) ``collective_s`` is 0.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode, flop_registry

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import LOCAL_SHARDS, param_bytes
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.ssm_scan.kernel import ssm_scan
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models.lm import RunConfig

# the kernels whose meta route counts its own operations, each with the
# peak its operations run at
_META_COUNTED = ((flash_attention, "bfloat16"), (ssm_scan, "float32"))


def traced_ops(fn, *args) -> dict:
    """FLOPs of one call ``fn(*args)``, as it runs, by the peak they run
    at: "bfloat16" what ``FlopCounterMode`` counts plus the attention
    kernel's meta-route count, "float32" the scan kernel's."""
    before = [k.meta_flops for k, _ in _META_COUNTED]
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    total = counter.get_total_flops()
    # a local call on a mesh (sharding.run_local) counted one shard's
    # products of n: add the other n - 1
    for name, counts in counter.get_flop_counts().items():
        m = LOCAL_SHARDS.search(name)
        if m:
            total += (int(m.group(1)) - 1) * sum(counts.values())
    ops = {"bfloat16": float(total), "float32": 0.0}
    for (k, dtype), b in zip(_META_COUNTED, before):
        ops[dtype] += k.meta_flops - b
    return ops


def traced_flops(fn, *args) -> float:
    """All of ``traced_ops``' FLOPs."""
    return sum(traced_ops(fn, *args).values())


# bytes each device sends per output byte, by op and group size g (the
# reference's table): a ring all-reduce sends 2 (g-1)/g of its output, an
# all-gather (g-1)/g, a reduce-scatter (g-1) (its output is 1/g of what
# it reduces), an all-to-all (g-1)/g, a permute its output
_WIRE_FACTOR = {
    "all-reduce": lambda g: 2 * (g - 1) / g,
    "all-gather": lambda g: (g - 1) / g,
    "reduce-scatter": lambda g: float(g - 1),
    "all-to-all": lambda g: (g - 1) / g,
    "collective-permute": lambda g: 1.0,
}

# the collectives DTensor issues, by the reference's op names
_COLLECTIVE_OPS = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}


@dataclass
class CollectiveStats:
    op_counts: dict = field(default_factory=dict)    # op -> count
    op_bytes: dict = field(default_factory=dict)     # output bytes
    wire_bytes_per_device: float = 0.0
    link_seconds: float = 0.0    # each op's wire bytes at its group's rate

    @property
    def total_output_bytes(self) -> float:
        return sum(self.op_bytes.values())

    def add(self, op: str, nbytes: int, ranks) -> None:
        g = len(ranks)
        if not nbytes or g <= 1:
            return
        wire = _WIRE_FACTOR[op](g) * nbytes
        self.op_counts[op] = self.op_counts.get(op, 0) + 1
        self.op_bytes[op] = self.op_bytes.get(op, 0) + nbytes
        self.wire_bytes_per_device += wire
        self.link_seconds += wire / mesh_mod.link_bw(ranks)

    def seconds(self) -> float:
        """Each collective's wire bytes at its own group's link rate (the
        reference charges all of them at one ICI link's)."""
        return self.link_seconds


class _DeviceCounter(TorchDispatchMode):
    """What one device runs of a step: its matrix products' FLOPs and the
    collectives it takes part in.  A DTensor op is handed back
    (``NotImplemented``) so that DTensor runs it on plain local tensors,
    which this mode then sees; an op on plain tensors (an unsharded step,
    a ``run_local`` call's body) is seen as it runs, and one on the fake
    tensors DTensor propagates shapes with is not counted.  DTensor's
    shard-to-shard all-to-all is recorded as one collective, and what it
    issues inside (on a CPU mesh, an all-gather it chunks) is not."""

    def __init__(self, stats: CollectiveStats):
        super().__init__()
        self.stats = stats
        self.flops = 0
        self.inside = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        if any(issubclass(t, FakeTensor) for t in types):
            # DTensor working out an output's shape, not a device's work
            return func(*args, **kwargs)
        name = getattr(func, "_opname", "")
        op = _COLLECTIVE_OPS.get(name) \
            if func.namespace in ("_c10d_functional", "_dtensor") else None
        if op is None or self.inside:
            out = func(*args, **kwargs)
            count = flop_registry.get(func._overloadpacket)
            if count is not None:
                self.flops += count(*args, **kwargs, out_val=out)
            return out
        self.inside += 1
        try:
            out = func(*args, **kwargs)
        finally:
            self.inside -= 1
        group = dist.distributed_c10d._resolve_process_group(args[-1])
        self.stats.add(op, out.numel() * out.element_size(),
                       dist.get_process_group_ranks(group))
        return out


def traced(fn, *args) -> tuple:
    """One call ``fn(*args)`` -> (``traced_ops``, one device's share of
    them by the same peaks, its ``CollectiveStats``), from the same run.

    One device's FLOPs are those of the ops it runs on its local shards
    (on the ``fake`` backend, rank 0's, the largest of uneven shards):
    a product DTensor splits over every mesh dim counts 1/n of its global
    FLOPs, and a product that some mesh dims leave replicated (a
    ``run_local`` kernel split only by the batch, KV heads whole on the
    model axis) counts the more that each device repeats."""
    stats = CollectiveStats()
    device = _DeviceCounter(stats)
    before = [k.meta_flops_device for k, _ in _META_COUNTED]
    with device:
        ops = traced_ops(fn, *args)
    per_device = {"bfloat16": float(device.flops), "float32": 0.0}
    for (k, dtype), b in zip(_META_COUNTED, before):
        per_device[dtype] += k.meta_flops_device - b
    return ops, per_device, stats


def activation_bytes(cfg: ArchConfig, shape: ShapeConfig,
                     run: RunConfig) -> float:
    """Activations alive at the step's peak, from the cost model's
    inventory (``costmodel.analytic_cost`` counts each such byte written
    once and read once): per layer the saved (B, T, D) activations in
    bf16, 4 of them without remat and 2.5 with, and the logits; a prefill
    2 per layer; a decode step none."""
    layers = cfg.n_layers * (2 if cfg.enc_dec else 1)
    tokens = shape.tokens_per_step
    if shape.kind == "train":
        per_layer = 4.0 if run.remat == "none" else 2.5
        return (layers * tokens * cfg.d_model * 2.0 * per_layer
                + tokens * cfg.padded_vocab() * 2.0)
    if shape.kind == "prefill":
        return layers * tokens * cfg.d_model * 2.0 * 2.0
    return 0.0


def batch_shards(rules, shape: ShapeConfig) -> int:
    """How many ways "act_batch" splits ``shape``'s batch under ``rules``
    (1 without)."""
    if rules is None:
        return 1
    spec = rules.spec_for(("act_batch",), (shape.global_batch,))
    return math.prod(rules.extent(a) for a in spec[0])


def memory_dict(cell, run: RunConfig) -> dict:
    """The reference's memory-analysis keys for a ``Cell``, per device:
    the argument and output trees' bytes, the bytes the outputs take over
    from donated arguments (the train state, a decode cache) and the
    activations (``temp``).  There is no generated code to count."""
    rules = cell.rules
    return {"argument_size_in_bytes": param_bytes(cell.arg_specs, rules),
            "output_size_in_bytes": param_bytes(cell.out_specs, rules),
            "alias_size_in_bytes": param_bytes(
                [cell.arg_specs[i] for i in cell.donated], rules),
            "temp_size_in_bytes": int(activation_bytes(
                cell.arch, cell.shape, run) / batch_shards(rules,
                                                           cell.shape))}


@dataclass
class Roofline:
    flops_per_device: float      # one device's traced (the reference:
                                 # HLO-derived, global / n_devices)
    hbm_bytes_per_device: float  # analytic inventory
    n_devices: int = 1
    model_flops_per_device: float = 0.0   # 6*N*D (2*N*D) + attention
    fp32_flops_per_device: float = 0.0    # of flops_per_device: CUDA cores
    coll: Optional[CollectiveStats] = None

    @property
    def compute_s(self) -> float:
        tensor = self.flops_per_device - self.fp32_flops_per_device
        return (tensor / mesh_mod.PEAK_FLOPS_BF16
                + self.fp32_flops_per_device / mesh_mod.PEAK_FLOPS_FP32)

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes_per_device / mesh_mod.HBM_BW

    @property
    def collective_s(self) -> float:
        return self.coll.seconds() if self.coll is not None else 0.0

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        if self.flops_per_device <= 0:
            return 0.0
        return self.model_flops_per_device / self.flops_per_device

    @property
    def roofline_fraction(self) -> float:
        """Fraction of peak sustained if the dominant term were the runtime:
        useful model FLOPs / (bound_s * peak)."""
        if self.bound_s <= 0:
            return 0.0
        return self.model_flops_per_device / (
            self.bound_s * mesh_mod.PEAK_FLOPS_BF16)

    def summary(self) -> dict:
        coll = self.coll or CollectiveStats()
        return {
            "hlo_flops_per_device": self.flops_per_device,
            "fp32_flops_per_device": self.fp32_flops_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_output_bytes": coll.total_output_bytes,
            "collective_wire_bytes_per_device": coll.wire_bytes_per_device,
            "collective_op_counts": dict(coll.op_counts),
            "collective_op_bytes": dict(coll.op_bytes),
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_fraction": self.roofline_fraction,
        }
