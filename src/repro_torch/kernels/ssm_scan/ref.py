"""Plain PyTorch version of the selective-scan kernel
(``repro.kernels.ssm_scan.ref.ssm_scan_ref``)."""
from __future__ import annotations

import torch


def ssm_scan_ref(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
                 cm: torch.Tensor, a: torch.Tensor, *,
                 return_state: bool = False):
    """x, dt: (B,T,Di); bm, cm: (B,T,N); a: (Di,N) -> y (B,T,Di) in x's
    dtype, and with ``return_state`` also the final h (B,Di,N) in float32.

    A sequential loop over T from h = 0, all in float32:
    h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t,  y_t = c_t . h_t."""
    b, t, di = x.shape
    n = bm.shape[-1]
    xf, dtf, bf, cf = x.float(), dt.float(), bm.float(), cm.float()
    af = a.float()
    h = torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
    y = torch.empty((b, t, di), dtype=torch.float32, device=x.device)
    for i in range(t):
        abar = torch.exp(dtf[:, i, :, None] * af)              # (B,Di,N)
        h = abar * h + (dtf[:, i] * xf[:, i])[:, :, None] * bf[:, i, None, :]
        y[:, i] = torch.einsum("bdn,bn->bd", h, cf[:, i])
    y = y.to(x.dtype)
    return (y, h) if return_state else y
