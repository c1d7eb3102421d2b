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
is no fallback from the card to the plain version.  A meta tensor (the
dry run, ``repro_torch.launch.dryrun``) computes nothing: that route
returns empty outputs of the kernel's shapes and dtypes and adds the
call's operations (``flops``, the same count ``chip_smoke.py`` bounds the
kernel by) to ``ssm_scan.meta_flops`` and ``meta_flops_device`` (one
device's, which ``run_local`` leaves unscaled); it never runs the plain
version's per-step loop, which at T = 524,288 would take minutes on the
host.  Any other device raises.

``plan`` is the launch rule: how many lanes of a warp share one channel's
states, and whether T is cut into chunks that run side by side (two CUDA
kernels a call instead of one).  It is a plain function of the shapes and
the card's SM count, so the CPU tests can hold its grids.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from pathlib import Path

import torch

from repro_torch.kernels.build import (build_library, call_on, read_log,
                                      stream_ptr)
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

MAX_STATE = 32
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the launch rule; THREADS is csrc/ssm_scan.cu's kThreads
THREADS = 128
LANES = (1, 2)           # lanes per channel, each holding 4 to 16 states
WARPS_PER_SM = 12        # fewer than this on an SM and the scan waits
MIN_CHUNK = 64           # shortest time chunk worth a second pass
CHUNK_ALIGN = 32         # chunk lengths are whole staged tiles
MAX_CHUNKS = 16

_SRC = Path(__file__).with_name("csrc") / "ssm_scan.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libssm_scan.so"
_LOG_PATH = _BUILD / "nvcc.log"
_lib = None


@dataclass(frozen=True)
class Plan:
    """One call's launch geometry.  A block of ``THREADS`` threads covers
    ``channels`` channels of one batch row, ``lanes`` threads a channel,
    each thread ``states`` of the channel's ``state_pad`` states (N
    rounded up to a power of two >= 4).  T is cut into ``chunks`` of
    ``chunk_len`` steps (the last one shorter); with more than one chunk
    pass 1 scans chunks 0 .. K-2 and pass 2 chunks 1 .. K-1."""
    lanes: int
    chunks: int
    chunk_len: int
    state_pad: int

    @property
    def states(self) -> int:
        return self.state_pad // self.lanes

    @property
    def channels(self) -> int:
        return THREADS // self.lanes

    @property
    def kernels(self) -> int:
        """CUDA kernels one call runs."""
        return 1 if self.chunks == 1 else 2

    def grid(self, b: int, di: int) -> tuple:
        """Blocks of each kernel: (channel blocks, chunks, batch rows)."""
        return (_cdiv(di, self.channels), max(self.chunks - 1, 1), b)


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _state_pad(n: int) -> int:
    return max(4, 1 << (n - 1).bit_length())


@functools.lru_cache(maxsize=4096)
def plan(b: int, t: int, di: int, n: int, sms: int) -> Plan:
    """The launch rule.  The fewest lanes per channel that give every SM
    ``WARPS_PER_SM`` warps (fewer lanes, fewer instructions per state
    update); where even the most lanes leave it short, T is cut into the
    chunks that come nearest to it, at least ``MIN_CHUNK`` steps each and
    at most ``MAX_CHUNKS`` (each pass runs K - 1 chunks side by side, so
    K = 2 would add a pass and no parallelism)."""
    pad = _state_pad(n)
    lanes_ok = [ln for ln in LANES if 4 <= pad // ln <= 16]
    target = WARPS_PER_SM * sms

    def warps(ln):
        return b * _cdiv(di, THREADS // ln) * THREADS // 32
    lanes = next((ln for ln in lanes_ok if warps(ln) >= target),
                 lanes_ok[-1])
    have = warps(lanes)
    k = 1 if have >= target else min(1 + round(target / have), MAX_CHUNKS,
                                      t // MIN_CHUNK)
    if k >= 3:
        chunk_len = _cdiv(_cdiv(t, k), CHUNK_ALIGN) * CHUNK_ALIGN
        k = _cdiv(t, chunk_len)
        if k >= 3:
            return Plan(lanes, k, chunk_len, pad)
    return Plan(lanes, 1, t, pad)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


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
        # PyDLL: the launch is short and does not block, so the call keeps
        # the GIL rather than releasing and taking it back
        lib = ctypes.PyDLL(str(_LIB_PATH))
        fn = lib.ssm_scan_fwd
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [
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


def flops(b: int, t: int, di: int, n: int) -> int:
    """Operations of one call, all float32: per state element and step
    dt*a, exp(.)*h, (dt x)*b, +, c*h and the sum over N (6), per channel
    and step dt*x (1).  The exponential is one of the six."""
    return 6 * b * t * di * n + b * t * di


def ssm_scan(x: torch.Tensor, dt: torch.Tensor, bm: torch.Tensor,
             cm: torch.Tensor, a: torch.Tensor, *,
             return_state: bool = False):
    """x, dt: (B,T,Di); bm, cm: (B,T,N); a: (Di,N) -> y (B,T,Di), and with
    ``return_state`` (y, h (B,Di,N) float32)."""
    _check(x, dt, bm, cm, a)
    if x.device.type == "cpu":
        return ssm_scan_ref(x, dt, bm, cm, a, return_state=return_state)
    b, t, di = x.shape
    if x.device.type == "meta":
        n = flops(b, t, di, bm.shape[-1])
        ssm_scan.meta_flops += n
        ssm_scan.meta_flops_device += n
        y = torch.empty_like(x)
        h = x.new_empty((b, di, bm.shape[-1]), dtype=torch.float32)
        return (y, h) if return_state else y
    if x.device.type != "cuda":
        raise ValueError(f"ssm_scan: no kernel for device {x.device}")
    y, h = launch(x, dt, bm, cm, a, plan(b, t, di, bm.shape[-1],
                                         _sm_count(x.device.index or 0)))
    if h.numel():
        ssm_scan.launches += 1
    return (y, h) if return_state else y


ssm_scan.launches = 0
ssm_scan.meta_flops = 0
ssm_scan.meta_flops_device = 0


def launch(x, dt, bm, cm, a, how: Plan) -> tuple:
    """Run the kernel on CUDA tensors with the launch geometry ``how``;
    -> (y, h).  ``ssm_scan`` calls it with ``plan``'s choice (and counts
    the call); ``chip_smoke.py`` times other plans through it."""
    x, dt, bm, cm, a = (v.contiguous() for v in (x, dt, bm, cm, a))
    b, t, di = x.shape
    n = bm.shape[-1]
    y = torch.empty_like(x)
    h = x.new_empty((b, di, n), dtype=torch.float32)
    if not h.numel():
        return y, h
    # the chunk carry's scratch: each chunk's end states, then its decay
    # products, (B, K - 1, Di, N) f32 each
    ends = prods = None
    if how.chunks > 1:
        scratch = x.new_empty(2 * b * (how.chunks - 1) * di * n,
                              dtype=torch.float32)
        ends = scratch.data_ptr()
        prods = ends + scratch.numel() * 2   # half the bytes on
    err = call_on(
        x.device, _load().ssm_scan_fwd, x.data_ptr(), dt.data_ptr(),
        bm.data_ptr(), cm.data_ptr(), a.data_ptr(), y.data_ptr(),
        h.data_ptr(), ends, prods, _DTYPE_CODES[x.dtype], b, t, di, n,
        how.lanes, how.chunks, how.chunk_len, stream_ptr(x.device))
    if err != 0:
        raise RuntimeError(f"ssm_scan: CUDA launch failed with cudaError "
                           f"{err}")
    return y, h
