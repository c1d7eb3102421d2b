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
raises.  There is no fallback from the card to the plain version.
"""
from __future__ import annotations

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
            ctypes.c_float, ctypes.c_void_p]
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


def _aligned(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, s_valid: int = 0) -> torch.Tensor:
    """q: (B, H, T, hd); k, v: (B, K, S, hd) -> (B, H, T, hd) in q's dtype.
    ``s_valid`` (0 = S): keys at or past it are masked."""
    s_valid = _check(q, k, v, s_valid)
    if q.device.type == "cpu":
        return attention_ref(q, k[:, :, :s_valid], v[:, :, :s_valid],
                             causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: no kernel for device {q.device}")
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    out = torch.empty_like(q)
    b, h, t, hd = q.shape
    if out.numel() == 0:
        return out
    lib = _load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, h, k.shape[1], t, k.shape[2], hd,
            s_valid, int(causal), 1.0 / math.sqrt(hd), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention: CUDA launch failed with "
                           f"cudaError {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
