"""Flash attention forward: the prefill attention of the serving path.

``flash_attention`` replaces the Pallas kernel of the same name in
``repro/kernels/flash_attention/kernel.py``: causal or full GQA attention,
q (B, H, T, hd) against k and v (B, K, S, hd) with H % K == 0, an online
softmax in float32, keys at or past ``s_valid`` masked.  Input and output
are float32 or bfloat16; hd is one of ``HEAD_DIMS``.

The tensor's device picks the route: a CPU tensor takes the plain PyTorch
version (``ref.attention_ref`` over the first ``s_valid`` keys, which is
the same function as masking the rest); a CUDA tensor launches the
hand-written kernel in ``csrc/flash_attention.cu`` (built with ``nvcc`` at
first use into ``build/`` beside this file, bound through ``ctypes``) or
raises.  There is no fallback from the card to the plain version, and
no backward on either route.  A meta tensor (the dry run,
``repro_torch.launch.dryrun``) computes nothing: that route returns an
empty output of the kernel's shape and dtype and adds the call's
operations (``flops``, the same count ``chip_smoke.py`` bounds the kernel
by) to ``flash_attention.meta_flops`` and ``meta_flops_device`` (on a
mesh, ``run_local`` scales the first to every shard of a local call and
leaves the second one device's).  Any other device raises.

The kernel reads q, k and v and writes o through their batch, head and
row strides, so strided views (the model's (B, T, H, hd) tensors seen as
(B, H, T, hd)) go in uncopied.  It needs hd contiguous and the base and
every stride of more than one element 16-byte aligned; an operand that
is not so is copied (``_operand``), nothing is refused for its layout.
"""
from __future__ import annotations

import array
import ctypes
import math
from pathlib import Path

import torch

from repro_torch.kernels.build import build_library, read_log
from repro_torch.kernels.flash_attention.ref import attention_ref

# the kernel's template instantiations: the TPU kernel's hd <= 256 cases of
# tests/test_kernels.py (32, 64, 128, 256), plus 16 for the reduced configs
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the C entry point's code for a failed tensor-map encode: this + CUresult
_ENCODE_ERROR = 10000

_SRC = Path(__file__).with_name("csrc") / "flash_attention.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libflash_attention.so"
_LOG_PATH = _BUILD / "nvcc.log"
_lib = None


def build(force: bool = False) -> float:
    """Compile ``csrc/flash_attention.cu`` into
    ``build/libflash_attention.so`` unless an up-to-date library is there.
    Returns the build seconds."""
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
        fn = lib.flash_attention_fwd
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           s_valid: int) -> int:
    """Validate shapes, dtypes and devices; -> the resolved s_valid."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q must be (B, H, T, hd) and k, v "
                         f"(B, K, S, hd); got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, h, _, hd = q.shape
    kb, kh, s, khd = k.shape
    if kb != b or khd != hd or kh == 0 or h % kh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (batch, hd, H % K == 0)")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head size {hd} not in "
                         f"{HEAD_DIMS}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_attention: q, k, v must share one dtype of "
                        f"float32/bfloat16; got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention: q, k, v on different devices "
                         f"({q.device}, {k.device}, {v.device})")
    s_valid = s_valid or s
    if not 0 < s_valid <= s:
        raise ValueError(f"flash_attention: s_valid {s_valid} outside "
                         f"(0, {s}]")
    return s_valid


def flops(b: int, h: int, t: int, s: int, hd: int, causal: bool) -> int:
    """Operations of one call over ``s`` valid keys: Q·Kᵀ and P·V, 2 each
    per (query, key) pair and head dim; causal query i sees keys
    0 .. min(i, s - 1)."""
    if not causal:
        pairs = t * s
    elif t <= s:
        pairs = t * (t + 1) // 2
    else:
        pairs = s * (s + 1) // 2 + (t - s) * s
    return 4 * b * h * hd * pairs


def _readable(x: torch.Tensor) -> bool:
    """Whether the kernel can read ``x`` in place: hd contiguous, base and
    every stride of a dimension longer than 1 a positive multiple of 16
    bytes (what TMA's tensor maps and the 16-byte loads take)."""
    size = x.element_size()
    if x.stride(3) != 1 or x.data_ptr() % 16:
        return False
    return all(n == 1 or (st > 0 and st * size % 16 == 0)
               for n, st in zip(x.shape[:3], x.stride()[:3]))


def _operand(x: torch.Tensor) -> torch.Tensor:
    """``x`` itself where the kernel can read it, else a contiguous copy."""
    if _readable(x):
        return x
    x = x.contiguous()
    return x if _readable(x) else x.clone()


def _kernel_strides(x: torch.Tensor) -> tuple:
    """The (batch, head, row) element strides handed to the kernel; a
    dimension of length 1 gets its contiguous stride, which is aligned
    whatever the tensor's own."""
    b, h, t, hd = x.shape
    sb, sh, st, _ = x.stride()
    return (sb if b > 1 else h * t * hd, sh if h > 1 else t * hd,
            st if t > 1 else hd)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int = 0,
                    out: torch.Tensor | None = None) -> torch.Tensor:
    """q: (B, H, T, hd); k, v: (B, K, S, hd) -> (B, H, T, hd) in q's dtype.
    ``s_valid`` (0 = S): keys at or past it are masked.  ``out``, where
    given, receives the result and is returned: it must have q's shape,
    dtype and device and a layout the kernel can write (see
    ``_readable``); without it the result takes q's layout where q is
    dense, else a contiguous one.  Inputs that require grad (with grad
    mode on) are refused on either route: the kernel has no backward,
    as the TPU kernel has none, so training takes the
    ``blocked_attention`` twin."""
    s_valid = _check(q, k, v, s_valid)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (q, k, v)):
        raise RuntimeError("flash_attention: no backward; inputs that "
                           "require grad belong on the blocked_attention "
                           "twin")
    if out is not None and (out.shape != q.shape or out.dtype != q.dtype
                            or out.device != q.device
                            or not _readable(out)):
        raise ValueError(f"flash_attention: out {tuple(out.shape)} "
                         f"{out.dtype} on {out.device} with strides "
                         f"{out.stride()} cannot take the result")
    if q.device.type == "cpu":
        res = attention_ref(q, k[:, :, :s_valid], v[:, :, :s_valid],
                            causal=causal)
        return res if out is None else out.copy_(res)
    if q.device.type == "meta":
        b, h, t, hd = q.shape
        n = flops(b, h, t, s_valid, hd, causal)
        flash_attention.meta_flops += n
        flash_attention.meta_flops_device += n
        return torch.empty_like(q) if out is None else out
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    q, k, v = _operand(q), _operand(k), _operand(v)
    if out is None:
        out = torch.empty_like(q)
    b, h, t, hd = q.shape
    if out.numel() == 0:
        return out
    lib = _load()
    strides = array.array("q", _kernel_strides(q) + _kernel_strides(k)
                          + _kernel_strides(v) + _kernel_strides(out))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, k.shape[1], t, k.shape[2], hd,
            s_valid, int(causal), 1.0 / math.sqrt(hd),
            strides.buffer_info()[0], stream)
    if err >= _ENCODE_ERROR:
        raise RuntimeError(f"flash_attention: cuTensorMapEncodeTiled "
                           f"failed with CUresult {err - _ENCODE_ERROR}")
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
flash_attention.meta_flops = 0
flash_attention.meta_flops_device = 0
