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
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, read_log
from repro_torch.kernels.pcor.ref import pcor_rows_ref

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
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


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
    mean = torch.empty(g, dtype=torch.float32, device=x.device)
    inv = torch.empty(g, dtype=torch.float32, device=x.device)
    lib = _load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.pcor_rows(x.data_ptr(), mean.data_ptr(), inv.data_ptr(),
                            out.data_ptr(), g, s, row_start, row_count,
                            stream)
    if err != 0:
        raise RuntimeError(f"pcor: CUDA launch failed with cudaError {err}")
    pcor.launches += 1
    return out


pcor.launches = 0
