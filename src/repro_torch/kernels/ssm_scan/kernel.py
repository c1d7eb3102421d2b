"""Selective scan: the prefill scan of the SSM and hybrid families.

``ssm_scan`` replaces the Pallas kernel of the same name in
``repro/kernels/ssm_scan/kernel.py``: x and dt (B, T, Di) in float32 or
bfloat16, bm and cm (B, T, N) and a (Di, N) in float32, 1 <= N <= 32;
h_t = exp(dt_t a) h_{t-1} + (dt_t x_t) b_t and y_t = c_t . h_t in float32
from h = 0.  It returns y (B, T, Di) in x's dtype and, with
``return_state``, the final h (B, Di, N) in float32, which prefill keeps
as the layer's ``SSMCache.h``.

The tensor's device picks the route: a CPU tensor takes the plain PyTorch
version (``ref.ssm_scan_ref``); a CUDA tensor launches the hand-written
kernel in ``csrc/ssm_scan.cu`` (built with ``nvcc`` at first use into
``build/`` beside this file, bound through ``ctypes``) or raises.  There
is no fallback from the card to the plain version.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, read_log
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

MAX_STATE = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_SRC = Path(__file__).with_name("csrc") / "ssm_scan.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libssm_scan.so"
_LOG_PATH = _BUILD / "nvcc.log"
_lib = None


def build(force: bool = False) -> float:
    """Compile ``csrc/ssm_scan.cu`` into ``build/libssm_scan.so`` unless an
    up-to-date library is there.  Returns the build seconds."""
    return build_library(_SRC, _LIB_PATH, _LOG_PATH, force)


def build_log() -> str:
    """The last build's compiler output (ptxas register and shared-memory
    use per instantiation)."""
    return read_log(_LOG_PATH)


def _load():
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(_LIB_PATH))
        fn = lib.ssm_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(x, dt, bm, cm, a) -> None:
    """Validate shapes, dtypes and devices."""
    if x.dim() != 3 or dt.shape != x.shape or bm.dim() != 3 \
            or cm.shape != bm.shape:
        raise ValueError(f"ssm_scan: x, dt must be (B, T, Di) and bm, cm "
                         f"(B, T, N); got {tuple(x.shape)}, "
                         f"{tuple(dt.shape)}, {tuple(bm.shape)}, "
                         f"{tuple(cm.shape)}")
    b, t, di = x.shape
    n = bm.shape[-1]
    if bm.shape[:2] != (b, t) or tuple(a.shape) != (di, n):
        raise ValueError(f"ssm_scan: bm {tuple(bm.shape)} or a "
                         f"{tuple(a.shape)} do not fit x {tuple(x.shape)}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"ssm_scan: state size {n} outside [1, "
                         f"{MAX_STATE}]")
    if x.dtype not in _DTYPE_CODES or dt.dtype != x.dtype:
        raise TypeError(f"ssm_scan: x and dt must share one dtype of "
                        f"float32/bfloat16; got {x.dtype}, {dt.dtype}")
    if not bm.dtype == cm.dtype == a.dtype == torch.float32:
        raise TypeError(f"ssm_scan: bm, cm and a must be float32; got "
                        f"{bm.dtype}, {cm.dtype}, {a.dtype}")
    if not x.device == dt.device == bm.device == cm.device == a.device:
        raise ValueError(f"ssm_scan: inputs on different devices "
                         f"({x.device}, {dt.device}, {bm.device}, "
                         f"{cm.device}, {a.device})")


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, *,
             return_state: bool = False):
    """x, dt: (B,T,Di); bm, cm: (B,T,N); a: (Di,N) -> y (B,T,Di), and with
    ``return_state`` (y, h (B,Di,N) float32)."""
    _check(x, dt, bm, cm, a)
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, bm, cm, a, return_state=return_state)
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {x.device}")
    x, dt, bm, cm, a = (v.contiguous() for v in (x, dt, bm, cm, a))
    b, t, di = x.shape
    n = bm.shape[-1]
    y = torch.empty_like(x)
    h = torch.empty((b, di, n), dtype=torch.float32, device=x.device)
    if h.numel():
        lib = _load()
        with torch.cuda.device(x.device):
            stream = torch.cuda.current_stream(x.device).cuda_stream
            err = lib.ssm_scan_fwd(
                x.data_ptr(), dt.data_ptr(), bm.data_ptr(), cm.data_ptr(),
                a.data_ptr(), y.data_ptr(), h.data_ptr(),
                _DTYPE_CODES[x.dtype], b, t, di, n, stream)
        if err != 0:
            raise RuntimeError(f"ssm_scan: CUDA launch failed with "
                               f"cudaError {err}")
        ssm_scan.launches += 1
    return (y, h) if return_state else y


ssm_scan.launches = 0
