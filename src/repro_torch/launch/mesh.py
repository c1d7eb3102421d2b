"""The device a cell runs on, and the card's constants for the roofline
(the counterpart of ``repro.launch.mesh``).

The reference builds XLA meshes of TPU v5e chips (``single_pod``,
``multi_pod``, ``host``) and keeps the chip's peak rates and its ICI link
rate beside them.  The port runs on one card, so a "mesh" is one
``torch.device``: ``device_by_name`` names the three it runs on.  The
multi-card meshes and ``ICI_BW_PER_LINK`` have no single-card
counterpart: nothing is sharded, so no collective moves a byte.

The constants are one NVIDIA H100 SXM's, from NVIDIA's data sheet (dense
rates, without sparsity, at the 700 W power limit; a card set below it
runs slower under load).
"""
from __future__ import annotations

import torch

PEAK_FLOPS_BF16 = 989e12          # FLOP/s, tensor cores, bf16 and fp16
PEAK_FLOPS_TF32 = 495e12          # FLOP/s, tensor cores, TF32
PEAK_FLOPS_FP32 = 67e12           # FLOP/s, CUDA cores, float32
HBM_BW = 3.35e12                  # B/s
HBM_BYTES = 80e9                  # B of device memory


def device_by_name(name: str) -> torch.device:
    """"card" (the first CUDA device; raises without one), "host" (the
    CPU) or "meta" (shapes and dtypes only: the dry run)."""
    if name == "card":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; use the host or "
                               "meta device")
        return torch.device("cuda", 0)
    if name == "host":
        return torch.device("cpu")
    if name == "meta":
        return torch.device("meta")
    raise ValueError(f"unknown device {name!r}")
