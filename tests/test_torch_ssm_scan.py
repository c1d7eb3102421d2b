"""Port parity for the selective-scan kernel's CPU route and the SSM block.

The launch rule (``kernel.plan``) at the serving paths' shapes and a few
SM counts: every (b, d, n) owned by one thread, every step in one time
chunk.  The port's ``ssm_scan_ref`` and ``ops.selective_scan`` (plain
version, CPU tensors) against the JAX package's ``selective_scan`` in
``interpret``
mode (the Pallas kernel) and in ``ref`` mode, on ``tests/test_kernels.py``'s
``SSM_CASES`` (N 4, 8 and 16; T and Di no multiple of any block).  Then
``models.ssm.ssm_train`` both ways: with ``return_state`` (the kernel's
route: y, the conv tail and the final h) and without (the chunked
associative twin), against the JAX ``ssm_train``.

Tolerances: 2e-4 in float32, ``test_kernels.py``'s (the same recurrence,
summed sequentially on one side and associatively on the other, and the
Pallas kernel's exponentials taken on (t, d, n) tiles); 2e-2 in bfloat16,
relative to the largest value (x, dt and y are bf16, so an element may
sit a bf16 step apart, and the two frameworks round bf16 intermediates of
the block at different places).  The CUDA route is held against the same
plain version on the card in ``tests/test_torch_gpu.py`` and
``chip_smoke.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, reduced
from repro.kernels.ssm_scan.ops import selective_scan as j_selective_scan
from repro.kernels.ssm_scan.ref import ssm_scan_ref as j_ssm_scan_ref
from repro.models import ssm as jssm
from repro_torch.kernels.ssm_scan import ops
from repro_torch.kernels.ssm_scan import kernel as scan_kernel
from repro_torch.kernels.ssm_scan.kernel import MAX_STATE, ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.models import ssm

# (B, T, Di, N), as in tests/test_kernels.py
SSM_CASES = [(2, 64, 256, 16), (1, 50, 130, 8), (3, 32, 128, 16),
             (2, 128, 384, 4), (1, 33, 257, 16)]
TOL = {"float32": 2e-4, "bfloat16": 2e-2}


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device with no kernel and no plain
    route (the wrappers read only ``device.type``)."""
    @property
    def device(self):
        return torch.device("xpu")


def _elsewhere(*xs) -> tuple:
    return tuple(torch.Tensor._make_subclass(_Elsewhere, x) for x in xs)


def _inputs(case, seed=0):
    """``test_kernels.py``'s distribution: dt small and positive, a < 0."""
    b, t, di, n = case
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, t, di)).astype(np.float32)
    dt = np.abs(rng.standard_normal((b, t, di))).astype(np.float32) * 0.1
    bm = rng.standard_normal((b, t, n)).astype(np.float32)
    cm = rng.standard_normal((b, t, n)).astype(np.float32)
    a = -np.abs(rng.standard_normal((di, n))).astype(np.float32)
    return x, dt, bm, cm, a


def _torch(arrays, dtype):
    """x and dt in ``dtype``; bm, cm and a stay float32."""
    x, dt, bm, cm, a = (torch.from_numpy(v) for v in arrays)
    return (x.to(getattr(torch, dtype)), dt.to(getattr(torch, dtype)),
            bm, cm, a)


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", SSM_CASES)
def test_selective_scan_matches_reference_kernel_and_oracle(case, dtype):
    arrays = _inputs(case)
    got = ops.selective_scan(*_torch(arrays, dtype))
    assert got.shape == case[:3] and got.dtype == getattr(torch, dtype)
    jx, jdt = (jnp.asarray(v, getattr(jnp, dtype)) for v in arrays[:2])
    jrest = [jnp.asarray(v) for v in arrays[2:]]
    for mode in ("interpret", "ref"):
        _close(got, j_selective_scan(jx, jdt, *jrest, mode=mode),
               TOL[dtype])


@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_ref_matches_reference_oracle(case):
    arrays = _inputs(case, seed=1)
    y, h = ssm_scan_ref(*_torch(arrays, "float32"), return_state=True)
    _close(y, j_ssm_scan_ref(*(jnp.asarray(v) for v in arrays)),
           TOL["float32"])
    assert h.shape == (case[0], case[2], case[3])
    assert h.dtype == torch.float32


def test_final_state_is_the_state_after_the_last_step():
    """h_T from one scan over T steps equals the state a scan over the
    first T - 1 steps hands to one more step."""
    x, dt, bm, cm, a = _torch(_inputs((2, 21, 40, 8), seed=2), "float32")
    _, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    _, h_prev = ssm_scan(x[:, :-1], dt[:, :-1], bm[:, :-1], cm[:, :-1], a,
                         return_state=True)
    step = torch.exp(dt[:, -1, :, None] * a) * h_prev \
        + (dt[:, -1] * x[:, -1])[:, :, None] * bm[:, -1, None, :]
    torch.testing.assert_close(h, step, rtol=1e-6, atol=1e-6)


def test_empty_sequence_leaves_the_state_at_zero():
    x, dt, bm, cm, a = _torch(_inputs((2, 0, 16, 4)), "float32")
    y, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    assert y.shape == (2, 0, 16) and not h.any()


def test_cpu_route_does_not_count_launches():
    before = ssm_scan.launches
    ops.selective_scan(*_torch(_inputs(SSM_CASES[0]), "float32"))
    assert ssm_scan.launches == before


def _small(n=4, dtype=torch.float32, device="cpu"):
    x = torch.zeros((1, 5, 8), dtype=dtype, device=device)
    bm = torch.zeros((1, 5, n), device=device)
    return x, x.clone(), bm, bm.clone(), torch.zeros((8, n), device=device)


@pytest.mark.parametrize("n", [0, MAX_STATE + 1, 64])
def test_unsupported_state_size_raises(n):
    with pytest.raises(ValueError, match="state size"):
        ssm_scan(*_small(n))


def test_mismatched_dtypes_raise():
    x, dt, bm, cm, a = _small()
    with pytest.raises(TypeError):
        ssm_scan(x, dt.bfloat16(), bm, cm, a)
    with pytest.raises(TypeError):
        ssm_scan(x.half(), dt.half(), bm, cm, a)
    with pytest.raises(TypeError):
        ssm_scan(x, dt, bm.bfloat16(), cm, a)
    with pytest.raises(TypeError):
        ssm_scan(x, dt, bm, cm, a.double())


def test_bad_shapes_raise():
    x, dt, bm, cm, a = _small()
    with pytest.raises(ValueError):
        ssm_scan(x, dt[:, :4], bm, cm, a)
    with pytest.raises(ValueError):
        ssm_scan(x, dt, bm[:, :4], cm[:, :4], a)
    with pytest.raises(ValueError):
        ssm_scan(x, dt, bm, cm, a[:7])


def test_mismatched_devices_raise():
    x, dt, bm, cm, a = _small()
    with pytest.raises(ValueError, match="different devices"):
        ssm_scan(x, dt, bm, cm, a.to("meta"))


def test_device_without_a_kernel_raises():
    with pytest.raises(ValueError, match="no kernel for device"):
        ssm_scan(*_elsewhere(*_small()))


# ------------------------------------------------------ the launch rule
# the serving paths' scan shapes: falcon-mamba-7b's batched launcher
# prefill and the engines' batch-1 prefills at falcon's and hymba's widths
PATH_SHAPES = [(8, 1024, 8192, 16)] + [
    (1, t, di, 16) for di in (8192, 3200)
    for t in (97, 250, 511, 512, 777, 1024, 1333, 1700, 2000)]


def _covered(how, b, di, n):
    """How often each (b, d, n) is owned by one thread of a block of the
    grid, as ``csrc/ssm_scan.cu`` maps them: block (x, ., z), thread i ->
    channel x * channels + i // lanes, states (i % lanes) * states + r,
    those past Di or N masked."""
    gx, _, gz = how.grid(b, di)
    assert gz == b
    count = np.zeros((b, di, n), np.int64)
    tid = np.arange(scan_kernel.THREADS)
    for x in range(gx):
        d = x * how.channels + tid // how.lanes
        for r in range(how.states):
            s = (tid % how.lanes) * how.states + r
            keep = (d < di) & (s < n)
            count[:, d[keep], s[keep]] += 1
    return count


@pytest.mark.parametrize("sms", [132, 114, 78, 16])
@pytest.mark.parametrize("case", PATH_SHAPES + [(1, 8192, 3200, 16),
                                                (2, 45, 100, 5)])
def test_launch_plan_covers_every_state_and_step_once(case, sms):
    b, t, di, n = case
    how = scan_kernel.plan(b, t, di, n, sms)
    assert how.lanes in scan_kernel.LANES
    assert 4 <= how.states <= 16 and how.states * how.lanes >= n
    assert how.channels * how.lanes == scan_kernel.THREADS
    assert (_covered(how, b, di, n) == 1).all()
    # chunk k holds steps [k L, min(T, (k + 1) L)); each kernel's grid
    # runs K - 1 chunks side by side (pass 1 chunks 0 .. K-2, pass 2
    # chunks 1 .. K-1), or the one chunk: every step lies in one non-empty
    # chunk
    k = how.chunks
    assert how.grid(b, di)[1] == max(k - 1, 1)
    assert how.kernels == (1 if k == 1 else 2)
    assert k == 1 or 3 <= k <= scan_kernel.MAX_CHUNKS
    spans = [range(c * how.chunk_len, min(t, (c + 1) * how.chunk_len))
             for c in range(k)]
    assert all(len(sp) for sp in spans) and sorted(
        i for sp in spans for i in sp) == list(range(t))


@pytest.mark.parametrize("sms", [132, 114])
def test_launch_plan_fills_the_card(sms):
    """One lane per channel where that already gives every SM
    ``WARPS_PER_SM`` warps (falcon's batched prefill); otherwise two, and
    batch-1 prefills long enough for ``MIN_CHUNK``-step chunks are cut
    into time chunks."""
    big = scan_kernel.plan(8, 1024, 8192, 16, sms)
    assert (big.lanes, big.chunks) == (1, 1)
    for t, di in ((1024, 8192), (2000, 3200), (8192, 3200)):
        how = scan_kernel.plan(1, t, di, 16, sms)
        assert how.lanes == 2 and how.chunks >= 3
        assert how.chunk_len >= scan_kernel.MIN_CHUNK
        assert how.chunk_len % scan_kernel.CHUNK_ALIGN == 0
    short = scan_kernel.plan(1, 97, 8192, 16, sms)
    assert short.chunks == 1 and short.chunk_len == 97


# ------------------------------------------------------------ the block
def _block_params(cfg, seed):
    """Random values for every SSM parameter (not the init's constants),
    the same numbers on both sides; A_log keeps a < 0."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, spec in jssm.ssm_specs(cfg).items():
        v = rng.standard_normal(spec.shape).astype(np.float32)
        scale = 1.0 / np.sqrt(spec.shape[0]) if len(spec.shape) > 1 else 0.3
        out[key] = v * scale
    out["A_log"] = np.log(np.arange(1, cfg.ssm.d_state + 1, dtype=np.float32)
                          )[None].repeat(cfg.d_inner, 0) + out["A_log"]
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("t", [2, 13, 37])
def test_ssm_train_with_state_matches_reference(t, dtype):
    """The prefill route (the kernel's plain version) against the JAX
    chunked ``ssm_train(..., return_state=True)``: output, conv tail and
    final state.  T 2 is shorter than d_conv - 1, so the tail is
    left-padded; T 37 leaves the JAX side a ragged last chunk of 8."""
    cfg = reduced(get_arch("falcon-mamba-7b"))
    pnp = _block_params(cfg, seed=t)
    x = np.random.default_rng(t + 100).standard_normal(
        (2, t, cfg.d_model)).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jout, jcache = jssm.ssm_train({k: jnp.asarray(v) for k, v in pnp.items()},
                                  jnp.asarray(x, jdt), cfg, chunk=8,
                                  return_state=True)
    p = {k: torch.from_numpy(v).to(tdt) for k, v in pnp.items()}
    out, cache = ssm.ssm_train(p, torch.from_numpy(x).to(tdt), cfg, chunk=8,
                               return_state=True)
    assert out.dtype == tdt
    assert cache.conv.dtype == cache.h.dtype == torch.float32
    assert cache.conv.shape == (2, cfg.ssm.d_conv - 1, cfg.d_inner)
    _close(out, jout, TOL[dtype])
    _close(cache.conv, jcache.conv, TOL[dtype])
    _close(cache.h, jcache.h, TOL[dtype])


@pytest.mark.parametrize("chunk", [4, 8, 256])
def test_chunked_twin_matches_reference(chunk):
    """``return_state=False``: the chunked associative scan, f32."""
    cfg = reduced(get_arch("falcon-mamba-7b"))
    pnp = _block_params(cfg, seed=7)
    x = np.random.default_rng(8).standard_normal(
        (2, 29, cfg.d_model)).astype(np.float32)
    want = jssm.ssm_train({k: jnp.asarray(v) for k, v in pnp.items()},
                          jnp.asarray(x), cfg, chunk=chunk)
    got = ssm.ssm_train({k: torch.from_numpy(v) for k, v in pnp.items()},
                        torch.from_numpy(x), cfg, chunk=chunk)
    _close(got, want, TOL["float32"])


def test_only_the_prefill_route_calls_the_kernel_wrapper(monkeypatch):
    cfg = reduced(get_arch("falcon-mamba-7b"))
    p = {k: torch.from_numpy(v) for k, v in _block_params(cfg, 3).items()}
    x = torch.randn((1, 9, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    calls = []
    real = ssm.ssm_ops.selective_scan

    def counting(*a, **kw):
        calls.append((a[0].dtype, kw))
        return real(*a, **kw)
    monkeypatch.setattr(ssm.ssm_ops, "selective_scan", counting)
    ssm.ssm_train(p, x.bfloat16(), cfg)
    assert calls == []
    ssm.ssm_train(p, x.bfloat16(), cfg, return_state=True)
    # y leaves the scan in f32: the kernel gets float32 x
    assert calls == [(torch.float32, {"return_state": True})]
