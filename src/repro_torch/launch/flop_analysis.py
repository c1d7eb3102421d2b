"""Roofline terms of one cell on one card (the counterpart of
``repro/launch/hlo_analysis.py``).

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
  HLO FLOPs).
* Bytes: ``memory_dict`` takes the argument, output and cache trees'
  bytes from their specs (``param_bytes``) and the activations from the
  cost model's inventory, in the reference's keys.
* ``Roofline`` keeps the reference's fields (but ``coll``), properties and
  ``summary()`` keys, against one H100's peak rates (``mesh``); the
  summary's ``hlo_flops_per_device`` holds the traced count, and
  ``fp32_flops_per_device`` the part of it ``compute_s`` charges at the
  float32 peak.

``parse_collectives`` and ``CollectiveStats`` have no single-card
counterpart: nothing is sharded, so no collective runs and
``collective_s`` is 0; the summary's collective keys read 0.
"""
from __future__ import annotations

from dataclasses import dataclass

from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import param_bytes
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
    ops = {"bfloat16": float(counter.get_total_flops()), "float32": 0.0}
    for (k, dtype), b in zip(_META_COUNTED, before):
        ops[dtype] += k.meta_flops - b
    return ops


def traced_flops(fn, *args) -> float:
    """All of ``traced_ops``' FLOPs."""
    return sum(traced_ops(fn, *args).values())


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


def memory_dict(cell, run: RunConfig) -> dict:
    """The reference's memory-analysis keys for a ``Cell``: the argument
    and output trees' bytes, the bytes the outputs take over from donated
    arguments (the train state, a decode cache) and the activations
    (``temp``).  There is no generated code to count."""
    return {"argument_size_in_bytes": param_bytes(cell.arg_specs),
            "output_size_in_bytes": param_bytes(cell.out_specs),
            "alias_size_in_bytes": param_bytes(
                [cell.arg_specs[i] for i in cell.donated]),
            "temp_size_in_bytes": int(activation_bytes(
                cell.arch, cell.shape, run))}


@dataclass
class Roofline:
    flops_per_device: float      # traced (the reference: HLO-derived)
    hbm_bytes_per_device: float  # analytic inventory
    n_devices: int = 1
    model_flops_per_device: float = 0.0   # 6*N*D (2*N*D) + attention
    fp32_flops_per_device: float = 0.0    # of flops_per_device: CUDA cores

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
        return 0.0

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
        return {
            "hlo_flops_per_device": self.flops_per_device,
            "fp32_flops_per_device": self.fp32_flops_per_device,
            "model_flops_per_device": self.model_flops_per_device,
            "useful_flops_ratio": self.useful_flops_ratio,
            "hbm_bytes_per_device": self.hbm_bytes_per_device,
            "collective_output_bytes": 0.0,
            "collective_wire_bytes_per_device": 0.0,
            "collective_op_counts": {},
            "collective_op_bytes": {},
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "roofline_fraction": self.roofline_fraction,
        }
