"""Public wrappers of the correlation kernel
(``repro.kernels.pcor.ops.correlate`` and ``pcor_strip``).

The reference's ``mode`` and ``block_g`` are gone: the tensor's device
picks the route (the CUDA kernel on the card, its plain version on the
CPU), and ``block_g`` sized the TPU's output tiles, which the kernel here
fixes itself.  ``pcor_strip`` is one SPRINT work unit: a strip of rows of
the correlation matrix, computed by the same kernel as the full matrix,
so on the card a strip equals those rows of ``correlate`` bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.pcor.kernel import pcor


def correlate(x: torch.Tensor) -> torch.Tensor:
    """x: (G, S) -> (G, G) float32 Pearson correlation of the rows."""
    return pcor(x)


def pcor_strip(x: torch.Tensor, row_start: int,
               row_count: int) -> torch.Tensor:
    """One worker's strip: rows [row_start, row_start + row_count) of the
    correlation matrix, (row_count, G) float32.  As
    ``jax.lax.dynamic_slice_in_dim`` does, a start that would run past
    the last row is clamped to G - row_count (and a negative one to 0)."""
    g = x.shape[0]
    if not 0 <= row_count <= g:
        raise ValueError(f"pcor_strip: row_count {row_count} outside "
                         f"[0, {g}]")
    row_start = min(max(int(row_start), 0), g - row_count)
    return pcor(x, row_start=row_start, row_count=row_count)
