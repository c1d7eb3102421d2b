"""Fused delta probe: the differencing-snapshot hot path on the card.

``fused_delta_tiles`` replaces the Pallas kernel of the same name in
``repro/kernels/delta_encode/kernel.py``.  Over (nblk, 8, 1024) int32 tile
views of the old and new state it returns the per-tile changed bitmap and
the changed XOR tiles compacted in ascending tile order.  Deltas are XOR
on the bit pattern, so they are exact for any float (NaN/Inf payloads
included) and unchanged tiles cost nothing downstream.

The tensor's device picks the route: a CPU tensor takes the plain PyTorch
version (``ref.fused_tiles_ref``); a CUDA tensor launches the hand-written
kernel in ``csrc/fused_delta.cu`` (built with ``nvcc`` at first use into
``build/`` beside this file, bound through ``ctypes``) or raises.  There is
no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

from repro_torch.kernels.delta_encode.ref import fused_tiles_ref

LANE = 1024
SUB = 8
TILE = SUB * LANE   # 8192 int32 elements per tile

_SRC = Path(__file__).with_name("csrc") / "fused_delta.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libfused_delta.so"
_LOG_PATH = _BUILD / "nvcc.log"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to "
                           "build the fused delta kernel")
    return str(path)


def build(force: bool = False) -> float:
    """Compile ``csrc/fused_delta.cu`` into ``build/libfused_delta.so``
    unless an up-to-date library is there.  Returns the build seconds."""
    if (not force and _LIB_PATH.exists()
            and _LIB_PATH.stat().st_mtime >= _SRC.stat().st_mtime):
        return 0.0
    _BUILD.mkdir(parents=True, exist_ok=True)
    tmp = _LIB_PATH.with_name(f"{_LIB_PATH.name}.{os.getpid()}.tmp")
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_SRC)],
                          capture_output=True, text=True)
    _LOG_PATH.write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                           f"{proc.stdout}\n{proc.stderr}")
    os.replace(tmp, _LIB_PATH)
    return time.perf_counter() - t0


def build_log() -> str:
    """The last build's compiler output (ptxas register and shared-memory
    use per kernel)."""
    return _LOG_PATH.read_text() if _LOG_PATH.exists() else ""


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        fn = lib.fused_delta_tiles
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check_tiles(o32: torch.Tensor, n32: torch.Tensor) -> None:
    for name, t in (("old", o32), ("new", n32)):
        if t.dtype != torch.int32 or t.dim() != 3 \
                or tuple(t.shape[1:]) != (SUB, LANE):
            raise ValueError(f"fused_delta_tiles: {name} must be (nblk, "
                             f"{SUB}, {LANE}) int32, got {tuple(t.shape)} "
                             f"{t.dtype}")
    if o32.shape != n32.shape or o32.device != n32.device:
        raise ValueError("fused_delta_tiles: old/new differ in shape or "
                         "device")


def fused_delta_tiles(o32: torch.Tensor, n32: torch.Tensor):
    """-> (bitmap (nblk,) int32, tiles).  The k = bitmap.sum() changed XOR
    tiles sit in ``tiles[:k]`` in ascending tile order; on the card
    ``tiles`` is (nblk, 8, 1024) and slots past k are unwritten."""
    _check_tiles(o32, n32)
    if o32.device.type == "cpu":
        return fused_tiles_ref(o32, n32)
    if o32.device.type != "cuda":
        raise ValueError(f"fused_delta_tiles: no kernel for device "
                         f"{o32.device}")
    if not (o32.is_contiguous() and n32.is_contiguous()):
        raise ValueError("fused_delta_tiles: inputs must be contiguous")
    if o32.data_ptr() % 16 or n32.data_ptr() % 16:
        raise ValueError("fused_delta_tiles: inputs must be 16-byte aligned")
    nblk = o32.shape[0]
    bitmap = torch.empty(nblk, dtype=torch.int32, device=o32.device)
    tiles = torch.empty((nblk, SUB, LANE), dtype=torch.int32,
                        device=o32.device)
    if nblk == 0:
        return bitmap, tiles
    lib = _load()
    offs = torch.empty(nblk, dtype=torch.int32, device=o32.device)
    with torch.cuda.device(o32.device):
        stream = torch.cuda.current_stream(o32.device).cuda_stream
        err = lib.fused_delta_tiles(o32.data_ptr(), n32.data_ptr(),
                                    bitmap.data_ptr(), tiles.data_ptr(),
                                    offs.data_ptr(), nblk, stream)
    if err != 0:
        raise RuntimeError(f"fused_delta_tiles: CUDA launch failed with "
                           f"cudaError {err}")
    fused_delta_tiles.launches += 1
    return bitmap, tiles


fused_delta_tiles.launches = 0


def _bitcast_i32(x: torch.Tensor) -> torch.Tensor:
    """Flat int32 view of ``x``'s bits; 16-bit dtypes pair up, an odd
    count padded with one zero half-word (as the reference pads)."""
    x = x.reshape(-1)
    if x.dtype == torch.int32:
        return x
    if x.dtype == torch.float32:
        return x.view(torch.int32)
    if x.dtype in (torch.bfloat16, torch.float16, torch.int16):
        x16 = x.view(torch.int16)
        if x16.numel() % 2:
            x16 = torch.cat([x16, x16.new_zeros(1)])
        return x16.view(torch.int32)
    raise TypeError(f"unsupported dtype {x.dtype}")


def as_i32_tiles(x: torch.Tensor):
    """-> ((nblk, SUB, LANE) int32, element count before padding).  A view
    of ``x``'s own storage when no padding is needed."""
    flat = _bitcast_i32(x)
    n = flat.numel()
    pad = (-n) % TILE
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat.view(-1, SUB, LANE), n
