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
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import attend as j_attend
from repro.kernels.flash_attention.ref import attention_ref as j_attention_ref
from repro_torch.kernels.flash_attention import ops
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
        flash_attention(*_qkv(device="meta"))


def test_bad_shapes_and_s_valid_raise():
    q, k, v = _qkv()
    with pytest.raises(ValueError):
        flash_attention(q, k[:, :1].expand(1, 3, 8, 64), v[:, :1]
                        .expand(1, 3, 8, 64))          # H % K != 0
    with pytest.raises(ValueError, match="s_valid"):
        flash_attention(q, k, v, s_valid=9)
