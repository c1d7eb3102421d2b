"""Public wrapper of the selective-scan kernel
(``repro.kernels.ssm_scan.ops.selective_scan``).

The reference's ``mode`` is gone: the tensors' device picks the route
(the CUDA kernel on the card, its plain version on the CPU).  The kernel
takes any T and Di and masks the ragged edge itself, so the reference's
T and Di padding is not needed on either route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.ssm_scan.kernel import ssm_scan


def selective_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                   cm: torch.Tensor, a: torch.Tensor, *,
                   return_state: bool = False):
    """x, dt: (B,T,Di); bm, cm: (B,T,N); a: (Di,N) -> (B,T,Di), and with
    ``return_state`` also the final state (B,Di,N) in float32."""
    return ssm_scan(x, dt, bm, cm, a, return_state=return_state)
