"""Delta kernels over (nblk, 8, 1024) int32 tile views of a state.

Each wrapper replaces the Pallas kernel of the same name in
``repro/kernels/delta_encode/kernel.py``:

* ``fused_delta_tiles``, the differencing-snapshot hot path: the per-tile
  changed bitmap and the changed XOR tiles compacted in ascending tile
  order;
* ``changed_bitmap``: the bitmap alone (the probe of the unfused
  ``changed_blocks``, followed by the plain ``gather_delta``);
* ``delta_encode``: every XOR tile and the bitmap (``diff_blocks``);
* ``delta_apply``: new = old ^ delta (``patch_blocks``).

Deltas are XOR on the bit pattern, so they are exact for any float
(NaN/Inf payloads included) and unchanged tiles cost nothing downstream.
``as_i32_tiles`` and ``_bitcast_back`` carry a tensor to tiles and back.

The tensor's device picks the route: a CPU tensor takes the plain PyTorch
version (``ref.py``); a CUDA tensor launches the hand-written kernel in
``csrc/fused_delta.cu`` (built with ``nvcc`` at first use into ``build/``
beside this file, bound through ``ctypes``) or raises.  There is no
fallback from the card to the plain version.  Each wrapper counts its
kernel launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels.build import (build_library, call_on, read_log,
                                      stream_ptr)
from repro_torch.kernels.delta_encode.ref import (changed_bitmap_ref,
                                                  delta_apply_ref,
                                                  delta_encode_ref,
                                                  fused_tiles_ref)

LANE = 1024
SUB = 8
TILE = SUB * LANE   # 8192 int32 elements per tile

_SRC = Path(__file__).with_name("csrc") / "fused_delta.cu"
_BUILD = Path(__file__).with_name("build")
_LIB_PATH = _BUILD / "libfused_delta.so"
_LOG_PATH = _BUILD / "nvcc.log"
# entry point -> number of tensor pointers before (nblk, stream)
_ENTRY_POINTS = {"fused_delta_tiles": 5, "changed_bitmap": 3,
                 "delta_encode": 4, "delta_apply": 3}
_lib = None


def build(force: bool = False) -> float:
    """Compile ``csrc/fused_delta.cu`` into ``build/libfused_delta.so``
    unless an up-to-date library is there.  Returns the build seconds."""
    return build_library(_SRC, _LIB_PATH, _LOG_PATH, force)


def build_log() -> str:
    """The last build's compiler output (ptxas register and shared-memory
    use per kernel)."""
    return read_log(_LOG_PATH)


def _load():
    global _lib
    if _lib is None:
        build()
        # PyDLL: the launches are short and do not block, so a call keeps
        # the GIL rather than releasing and taking it back
        lib = ctypes.PyDLL(str(_LIB_PATH))
        for name, n_ptrs in _ENTRY_POINTS.items():
            fn = getattr(lib, name)
            fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_longlong,
                                                        ctypes.c_void_p]
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def _on_card(name: str, a: torch.Tensor, b: torch.Tensor) -> bool:
    """Check a pair of (nblk, SUB, LANE) int32 tile tensors; -> True for
    the kernel route (CUDA), False for the plain one (CPU).  Raises on
    anything the kernel does not take."""
    if not (a.dtype == b.dtype == torch.int32 and a.shape == b.shape
            and a.dim() == 3 and a.shape[1:] == (SUB, LANE)):
        raise ValueError(f"{name}: inputs must be two (nblk, {SUB}, {LANE}) "
                         f"int32 tensors of one shape, got "
                         f"{tuple(a.shape)} {a.dtype} and {tuple(b.shape)} "
                         f"{b.dtype}")
    dev = a.device
    if dev != b.device:
        raise ValueError(f"{name}: inputs on different devices ({dev}, "
                         f"{b.device})")
    if dev.type == "cpu":
        return False
    if dev.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {dev}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(f"{name}: inputs must be contiguous")
    if (a.data_ptr() | b.data_ptr()) % 16:
        raise ValueError(f"{name}: inputs must be 16-byte aligned")
    return True


def _launch(wrapper, *tensors: torch.Tensor) -> None:
    """Call the entry point of ``wrapper``'s name on the tensors' pointers,
    over the first tensor's tiles, on the current stream; count the
    launch on ``wrapper``."""
    name = wrapper.__name__
    dev = tensors[0].device
    err = call_on(dev, getattr(_load(), name),
                  *(t.data_ptr() for t in tensors), tensors[0].shape[0],
                  stream_ptr(dev))
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError "
                           f"{err}")
    wrapper.launches += 1


def _tiles_like(t: torch.Tensor) -> torch.Tensor:
    """An (nblk, SUB, LANE) int32 output beside the checked tiles ``t``."""
    return torch.empty_like(t)


def _bitmap_like(t: torch.Tensor) -> torch.Tensor:
    return t.new_empty(t.shape[0])


def fused_delta_tiles(o32: torch.Tensor, n32: torch.Tensor):
    """-> (bitmap (nblk,) int32, tiles).  The k = bitmap.sum() changed XOR
    tiles sit in ``tiles[:k]`` in ascending tile order; on the card
    ``tiles`` is (nblk, 8, 1024) and slots past k are unwritten."""
    if not _on_card("fused_delta_tiles", o32, n32):
        return fused_tiles_ref(o32, n32)
    bitmap, tiles = _bitmap_like(o32), _tiles_like(o32)
    if o32.shape[0]:
        _launch(fused_delta_tiles, o32, n32, bitmap, tiles,
                _bitmap_like(o32))          # the scan's offsets
    return bitmap, tiles


def changed_bitmap(o32: torch.Tensor, n32: torch.Tensor) -> torch.Tensor:
    """-> (nblk,) int32, 1 where tile i of old and new differs."""
    if not _on_card("changed_bitmap", o32, n32):
        return changed_bitmap_ref(o32, n32)
    bitmap = _bitmap_like(o32)
    if o32.shape[0]:
        _launch(changed_bitmap, o32, n32, bitmap)
    return bitmap


def delta_encode(o32: torch.Tensor, n32: torch.Tensor):
    """-> (delta (nblk, 8, 1024) int32 = old ^ new, bitmap (nblk,) int32)."""
    if not _on_card("delta_encode", o32, n32):
        return delta_encode_ref(o32, n32)
    delta, bitmap = _tiles_like(o32), _bitmap_like(o32)
    if o32.shape[0]:
        _launch(delta_encode, o32, n32, delta, bitmap)
    return delta, bitmap


def delta_apply(o32: torch.Tensor, d32: torch.Tensor) -> torch.Tensor:
    """-> new (nblk, 8, 1024) int32 = old ^ delta."""
    if not _on_card("delta_apply", o32, d32):
        return delta_apply_ref(o32, d32)
    new = _tiles_like(o32)
    if o32.shape[0]:
        _launch(delta_apply, o32, d32, new)
    return new


for _fn in (fused_delta_tiles, changed_bitmap, delta_encode, delta_apply):
    _fn.launches = 0


def gather_delta(o32: torch.Tensor, n32: torch.Tensor,
                 idx: torch.Tensor) -> torch.Tensor:
    """The changed tiles ``idx`` of old ^ new, (k, 8, 1024) int32: plain
    torch ops (index, then XOR), as the reference's is plain jnp."""
    return torch.bitwise_xor(o32[idx], n32[idx])


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


def _bitcast_back(flat_i32: torch.Tensor, shape, dtype) -> torch.Tensor:
    """Flat int32 words -> a tensor of ``shape`` and ``dtype`` made of
    their leading bytes: the tile padding, and the padding half-word of an
    odd 16-bit count, are dropped."""
    nbytes = torch.Size(shape).numel() * dtype.itemsize
    raw = flat_i32.reshape(-1).view(torch.uint8)[:nbytes]
    return raw.view(dtype).reshape(shape)
