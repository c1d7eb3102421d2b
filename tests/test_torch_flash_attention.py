"""Port parity for the flash-attention kernel's CPU route.

The port's ``attention_ref`` and ``ops.attend`` (plain version, CPU
tensors) against the JAX package's ``attend`` in ``interpret`` mode (the
Pallas kernel) and in ``ref`` mode, on ``tests/test_kernels.py``'s
``ATTN_CASES``: hd 32 to 256, MQA, non-causal with S > T, and T and S that
are no multiple of any block.  Tolerances are ``test_kernels.py``'s:
2e-5 in float32 (the same f32 arithmetic, summed in another order; the
kernel also scales q before its product where the reference divides the
scores) and 2e-2 in bfloat16 (the output is rounded to bf16 on both
sides, so an element may sit one bf16 step apart).  The CUDA route is
held against the same plain version on the card in
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  The kernel reads its
operands through their strides, so the last tests pin which layouts the
wrapper hands over in place, which it copies and which ``out`` it refuses.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attend as j_attend
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import kernel, ops
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref

ATTN_CASES = [
    # (B, T, S, H, K, hd, causal), as in tests/test_kernels.py
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 384, 8, 8, 32, False),
    (2, 200, 200, 6, 3, 64, True),      # non-block-multiple T/S
    (1, 96, 96, 4, 1, 128, False),      # MQA
    (1, 64, 64, 2, 2, 256, True),
]
TOL = {"float32": 2e-5, "bfloat16": 2e-2}


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    route (the wrappers read only ``device.type``)."""
    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(*xs) -> tuple:
    return tuple(torch.Tensor._make_subclass(_Elsewhere, x) for x in xs)


def _inputs(case, seed=0):
    b, t, s, h, k, hd, _ = case
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, t, h, hd)).astype(np.float32),
            rng.standard_normal((b, s, k, hd)).astype(np.float32),
            rng.standard_normal((b, s, k, hd)).astype(np.float32))


def _torch(x, dtype):
    return torch.from_numpy(x).to(getattr(torch, dtype))


def _close(got: torch.Tensor, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_attend_matches_reference_kernel_and_oracle(case, dtype):
    causal = case[-1]
    q, k, v = _inputs(case)
    jq, jk, jv = (jnp.asarray(x, getattr(jnp, dtype)) for x in (q, k, v))
    got = ops.attend(_torch(q, dtype), _torch(k, dtype), _torch(v, dtype),
                     causal=causal)
    assert got.shape == q.shape and got.dtype == getattr(torch, dtype)
    for mode in ("interpret", "ref"):
        _close(got, j_attend(jq, jk, jv, causal=causal, mode=mode),
               TOL[dtype])


@pytest.mark.parametrize("case", ATTN_CASES)
def test_attention_ref_matches_reference_oracle(case):
    causal = case[-1]
    q, k, v = (x.transpose(0, 2, 1, 3) for x in _inputs(case, seed=1))
    got = attention_ref(*(torch.from_numpy(x.copy()) for x in (q, k, v)),
                        causal=causal)
    want = j_attention_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           causal=causal)
    _close(got, want, TOL["float32"])


def test_s_valid_masks_the_padded_tail_as_the_kernel_does():
    """Keys at or past ``s_valid`` are masked: the port on S padded to the
    block against the JAX wrapper, which pads and passes ``s_valid``."""
    case = (1, 100, 100, 4, 2, 32, False)
    q, k, v = _inputs(case, seed=2)
    pad = ((0, 0), (0, 28), (0, 0), (0, 0))
    kt, vt = (torch.from_numpy(np.pad(x, pad)).transpose(1, 2)
              for x in (k, v))
    got = flash_attention(torch.from_numpy(q).transpose(1, 2), kt, vt,
                          causal=False, s_valid=100).transpose(1, 2)
    want = j_attend(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                    causal=False, mode="interpret")
    _close(got, want, TOL["float32"])


def test_cpu_route_does_not_count_launches():
    q, k, v = (torch.from_numpy(x) for x in _inputs(ATTN_CASES[0]))
    before = flash_attention.launches
    ops.attend(q, k, v, causal=True)
    assert flash_attention.launches == before


def _qkv(hd=64, dtype=torch.float32, device="cpu"):
    q = torch.zeros((1, 4, 8, hd), dtype=dtype, device=device)
    k = torch.zeros((1, 2, 8, hd), dtype=dtype, device=device)
    return q, k, k.clone()


@pytest.mark.parametrize("hd", [8, 48, 96, 512])
def test_unsupported_head_size_raises(hd):
    assert hd not in HEAD_DIMS
    with pytest.raises(ValueError, match="head size"):
        flash_attention(*_qkv(hd))


def test_mismatched_dtypes_raise():
    q, k, v = _qkv()
    with pytest.raises(TypeError):
        flash_attention(q, k.bfloat16(), v.bfloat16())
    with pytest.raises(TypeError):
        flash_attention(*_qkv(dtype=torch.float16))


def test_mismatched_devices_raise():
    q, k, v = _qkv()
    with pytest.raises(ValueError, match="different devices"):
        flash_attention(q, k.to("meta"), v.to("meta"))


def test_device_without_a_kernel_raises():
    with pytest.raises(ValueError, match="no kernel for device"):
        flash_attention(*_elsewhere(*_qkv()))


def test_bad_shapes_and_s_valid_raise():
    q, k, v = _qkv()
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1].expand(1, 3, 8, 64), v[:, :1]
                        .expand(1, 3, 8, 64))          # H % K != 0
    with pytest.raises(ValueError, match="s_valid"):
        flash_attention(q, k, v, s_valid=9)


# ---- strided operands: what the CUDA route reads in place, copies or refuses

def _fused(case, dtype, seed=3):
    """q, k, v as (B, T, *, hd) slices of one fused (B, T, H + 2K, hd)
    array, the numpy arrays they hold, and the fused tensor."""
    b, t, s, h, kh, hd, _ = case
    assert s == t
    rng = np.random.default_rng(seed)
    fused = rng.standard_normal((b, t, h + 2 * kh, hd)).astype(np.float32)
    ft = _torch(fused, dtype)
    views = (ft[:, :, :h], ft[:, :, h:h + kh], ft[:, :, h + kh:])
    arrays = (fused[:, :, :h], fused[:, :, h:h + kh], fused[:, :, h + kh:])
    return views, arrays


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [c for c in ATTN_CASES if c[1] == c[2]])
def test_attend_on_strided_views_matches_reference(case, dtype):
    """``attend`` on non-contiguous (B, T, H, hd) views, slices of one fused
    projection, against the JAX package's ``attend`` on the same values."""
    causal = case[-1]
    (q, k, v), arrays = _fused(case, dtype)
    assert not q.is_contiguous() and not k.is_contiguous()
    got = ops.attend(q, k, v, causal=causal)
    assert got.shape == q.shape and got.is_contiguous()
    jq, jk, jv = (jnp.asarray(np.ascontiguousarray(x), getattr(jnp, dtype))
                  for x in arrays)
    for mode in ("interpret", "ref"):
        _close(got, j_attend(jq, jk, jv, causal=causal, mode=mode),
               TOL[dtype])


def _bhtd(b=2, h=4, t=8, hd=64, dtype=torch.bfloat16):
    return torch.randn((b, h, t, hd)).to(dtype)


def _read_in_place():
    """Layouts the kernel reads through their strides: (name, tensor)."""
    fused = torch.randn((2, 8, 4 + 2 * 2, 64)).bfloat16()
    odd_b = torch.randn((1, 4, 8, 64)).as_strided(
        (1, 4, 8, 64), (3, 8 * 64, 64, 1))           # length-1 batch
    return [("contiguous", _bhtd()),
            ("transposed (B, T, H, hd)",
             torch.randn((2, 8, 4, 64)).bfloat16().transpose(1, 2)),
            ("q slice of a fused projection", fused[:, :, :4].transpose(1, 2)),
            ("v slice of a fused projection",
             fused[:, :, 6:].transpose(1, 2)),
            ("hd 16, f32", _bhtd(hd=16, dtype=torch.float32)),
            ("odd stride on a length-1 dim", odd_b)]


def _copied():
    """Layouts the wrapper copies: (name, tensor)."""
    flat = torch.randn(2 * 4 * 8 * 64 + 1).bfloat16()
    padded = torch.randn((2, 4, 8, 65)).bfloat16()
    return [("hd not contiguous",
             torch.randn((2, 4, 64, 8)).bfloat16().transpose(2, 3)),
            ("unaligned base", flat[1:].view(2, 4, 8, 64)),
            ("unaligned row stride", padded[..., :64]),
            ("zero stride (expanded heads)",
             torch.randn((2, 1, 8, 64)).bfloat16().expand(2, 4, 8, 64))]


@pytest.mark.parametrize("idx", range(6))
def test_operand_reads_strided_layouts_in_place(idx):
    name, x = _read_in_place()[idx]
    assert kernel._readable(x), name
    assert kernel._operand(x) is x, name


@pytest.mark.parametrize("idx", range(4))
def test_operand_copies_what_the_kernel_cannot_read(idx):
    name, x = _copied()[idx]
    assert not kernel._readable(x), name
    y = kernel._operand(x)
    assert y is not x and y.is_contiguous() and y.data_ptr() % 16 == 0
    assert kernel._readable(y) and torch.equal(y, x), name


def test_kernel_strides_normalise_length_one_dims():
    x = _read_in_place()[5][1]
    assert kernel._kernel_strides(x) == (4 * 8 * 64, 8 * 64, 64)
    t = torch.randn((2, 8, 4, 64)).transpose(1, 2)
    assert kernel._kernel_strides(t) == (8 * 4 * 64, 64, 4 * 64)


def test_out_takes_the_result_in_its_own_layout():
    q, k, v = (torch.from_numpy(x) for x in _inputs(ATTN_CASES[0]))
    out = torch.empty_like(q)                        # (B, T, H, hd)
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), out=out.transpose(1, 2))
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out, ops.attend(q, k, v))


@pytest.mark.parametrize("bad", ["shape", "dtype", "hd stride",
                                 "unaligned stride"])
def test_out_that_cannot_take_the_result_raises(bad):
    q, k, v = _qkv()
    out = {"shape": torch.empty((1, 4, 9, 64)),
           "dtype": torch.empty_like(q).bfloat16(),
           "hd stride": torch.empty((1, 4, 64, 8)).transpose(2, 3),
           "unaligned stride": torch.empty((1, 4, 8, 65))[..., :64]}[bad]
    with pytest.raises(ValueError, match="cannot take the result"):
        flash_attention(q, k, v, out=out)
