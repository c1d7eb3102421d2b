"""Plain PyTorch version of the correlation kernel
(``repro.kernels.pcor.ref.pcor_ref``).

Each row is centred over its samples and divided by its norm, floored at
1e-30, then z @ z.T.  On the card the product must run in full float32:
TF32 keeps about three decimal digits and would miss the 1e-5 limit the
kernel is held to, so a CUDA call sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` (PyTorch's defaults for a
matrix product, but a caller may have changed them)."""
from __future__ import annotations

import torch


def _standardized(x: torch.Tensor) -> torch.Tensor:
    if x.is_cuda:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    x = x.to(torch.float32)
    xc = x - x.mean(dim=1, keepdim=True)
    norm = torch.sqrt(torch.sum(xc * xc, dim=1, keepdim=True))
    return xc / torch.clamp_min(norm, 1e-30)


def pcor_ref(x: torch.Tensor) -> torch.Tensor:
    """x: (G, S) -> (G, G) float32 Pearson correlation of the rows."""
    z = _standardized(x)
    return z @ z.T


def pcor_rows_ref(x: torch.Tensor, row_start: int,
                  row_count: int) -> torch.Tensor:
    """Rows [row_start, row_start + row_count) of ``pcor_ref(x)``:
    (row_count, G) float32."""
    z = _standardized(x)
    return z[row_start:row_start + row_count] @ z.T
