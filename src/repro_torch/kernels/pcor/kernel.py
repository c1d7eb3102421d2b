"""Pearson correlation of the rows of X: the SPRINT ``pcor`` work unit.

``pcor`` replaces the Pallas kernel of the same name in
``repro/kernels/pcor/kernel.py``: x (G, S) of any float dtype, cast to
float32 as the Pallas body casts it; each row standardised over its S
samples (mean = sum x 1/S, inv = rsqrt(max(sum (x - mean)^2, 1e-30))),
then z_i . z_j.  It returns rows [row_start, row_start + row_count) of
the (G, G) float32 matrix; the defaults give the whole matrix.

The tensor's device picks the route: a CPU tensor takes the plain PyTorch
version (``ref.pcor_rows_ref``); a CUDA tensor launches the hand-written
kernel in ``csrc/pcor.cu`` (built with ``nvcc`` at first use into
``build/`` beside this file, bound through ``ctypes``) or raises.  There
is no fallback from the card to the plain version.  The two floor the
spread differently (the kernel the variance, as the Pallas kernel does;
the plain version the norm, as ``pcor_ref`` does): they differ only for
rows whose variance is below 1e-30, and both give 0 for a constant row.

The kernel computes one triangle of 128 x 128 tile pairs in a canonical
orientation (``csrc/pcor.cu``); ``plan`` lists the pairs a strip computes,
in the order of the kernel's grid.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (build_library, call_on, read_log,
                                      stream_ptr)
from repro_torch.kernels.pcor.ref import pcor_rows_ref

TILE = 128      # output tile edge, aligned to absolute rows
DEPTH = 16      # samples per ring stage: S is padded to a multiple of it

_SRC = Path(__file__).with_name("csrc") / "pcor.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libpcor.so"
_LOG_PATH = _BUILD / "nvcc.log"
_lib = None


def build(force: bool = False) -> float:
    """Compile ``csrc/pcor.cu`` into ``build/libpcor.so`` unless an
    up-to-date library is there.  Returns the build seconds."""
    return build_library(_SRC, _LIB_PATH, _LOG_PATH, force)


def build_log() -> str:
    """The last build's compiler output (ptxas register and shared-memory
    use per kernel)."""
    return read_log(_LOG_PATH)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        fn = lib.pcor_rows
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
            ctypes.c_longlong, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _tiles(g: int, row_start: int, row_count: int) -> tuple:
    """-> (tiles of G, first and last tile of the strip's rows)."""
    return (-(-g // TILE), row_start // TILE,
            (row_start + row_count - 1) // TILE)


def plan(g: int, row_start: int, row_count: int) -> list:
    """The tile pairs (I, J), I <= J, that the kernel computes for rows
    [row_start, row_start + row_count) of a G-row matrix, in its grid's
    order: first the pairs whose B rows alone lie in the strip (I before
    the strip's first tile t0, J in the strip's tiles), then each of the
    strip's tiles I with every J >= I.  A pair stores the strip's rows of
    its A tile as computed and, off the diagonal, those of its B tile
    transposed; so element (i, j) comes from the pair (tile(min(i, j)),
    tile(max(i, j))) at position (min, max), and only from it."""
    if row_count <= 0:
        return []
    nt, t0, t1 = _tiles(g, row_start, row_count)
    return ([(i, j) for i in range(t0) for j in range(t0, t1 + 1)]
            + [(i, j) for i in range(t0, t1 + 1) for j in range(i, nt)])


def n_pairs(g: int, row_start: int, row_count: int) -> int:
    """``len(plan(g, row_start, row_count))``, in closed form: the size of
    the kernel's grid."""
    nt, t0, t1 = _tiles(g, row_start, row_count)
    width = t1 - t0 + 1
    return t0 * width + width * nt - (t0 + t1) * width // 2


def pcor(x: torch.Tensor, *, row_start: int = 0,
         row_count: int | None = None) -> torch.Tensor:
    """x: (G, S) float -> rows [row_start, row_start + row_count) of its
    (G, G) float32 row-correlation matrix, (row_count, G)."""
    if x.dim() != 2 or not x.is_floating_point():
        raise ValueError(f"pcor: x must be a (G, S) float tensor, got "
                         f"{tuple(x.shape)} {x.dtype}")
    g, s = x.shape
    if row_count is None:
        row_count = g - row_start
    if s < 1 or row_start < 0 or row_count < 0 or row_start + row_count > g:
        raise ValueError(f"pcor: rows [{row_start}, {row_start + row_count})"
                         f" outside a ({g}, {s}) matrix with S >= 1")
    if x.device.type == "cpu":
        return pcor_rows_ref(x, row_start, row_count)
    if x.device.type != "cuda":
        raise ValueError(f"pcor: no kernel for device {x.device}")
    x = x.to(torch.float32).contiguous()
    out = torch.empty((row_count, g), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    s_pad = -(-s // DEPTH) * DEPTH
    # z_hi and z_lo, the standardised rows split into two TF32 terms
    z = torch.empty((2, g, s_pad), dtype=torch.float32, device=x.device)
    dev = x.device
    err = call_on(dev, _load().pcor_rows, x.data_ptr(), z.data_ptr(),
                  out.data_ptr(), g, s, s_pad, row_start, row_count,
                  n_pairs(g, row_start, row_count), stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"pcor: CUDA launch failed with cudaError {err}")
    pcor.launches += 1
    return out


pcor.launches = 0
