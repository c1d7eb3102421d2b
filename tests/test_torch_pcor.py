"""Port parity for the SPRINT correlation kernel and its work-unit flow.

The port's ``correlate`` and ``pcor_strip`` (on the CPU, the plain
version ``pcor_rows_ref``) are held against the JAX package's
``correlate`` in Pallas interpret mode and its ``pcor_strip``, on the same
inputs made with numpy.  Tolerances are ``tests/test_kernels.py``'s: 1e-5
against the JAX kernel (float32, the same sums in another order, and the
kernel's variance floor against the plain version's norm floor, which
differ only for rows of variance below 1e-30), 1e-4 against
``np.corrcoef`` (float64), and the diagonal within 1e-5 of 1.  The CUDA
kernel is held against the plain version on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.kernels.pcor.ops import correlate as j_correlate
from repro.kernels.pcor.ops import pcor_strip as j_pcor_strip
from repro_torch.kernels.pcor.kernel import TILE, n_pairs, pcor, plan
from repro_torch.kernels.pcor.ops import correlate, pcor_strip
from repro_torch.kernels.pcor.ref import pcor_ref


def _x(g: int, s: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((g, s)) \
        .astype(np.float32)


@pytest.mark.parametrize("g,s", [(150, 321), (256, 128), (100, 50), (64, 7)])
def test_correlate_matches_reference_and_numpy(g, s):
    x = _x(g, s, g + s)
    out = correlate(torch.from_numpy(x)).numpy()
    assert out.shape == (g, g) and out.dtype == np.float32
    want = np.asarray(j_correlate(x, mode="interpret"))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.corrcoef(x), rtol=1e-4, atol=1e-4)
    assert np.allclose(np.diag(out), 1.0, atol=1e-5)


def test_all_zero_row_correlates_to_zero():
    x = _x(40, 33, 1)
    x[7] = 0.0
    out = correlate(torch.from_numpy(x)).numpy()
    want = np.asarray(j_correlate(x, mode="interpret"))
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-5)
    assert not out[7].any() and not out[:, 7].any()
    assert np.isfinite(out).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16,
                                   torch.float64])
def test_correlate_casts_to_float32(dtype):
    x = torch.from_numpy(_x(50, 40, 2)).to(dtype)
    out = correlate(x)
    assert out.dtype == torch.float32
    want = np.asarray(j_correlate(x.float().numpy(), mode="interpret"))
    np.testing.assert_allclose(out.numpy(), want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("row_start,row_count", [
    (0, 100), (100, 100), (37, 51), (0, 1),
    (150, 100),       # runs past the last row: clamped to 100
    (199, 1),
])
def test_pcor_strip_matches_reference(row_start, row_count):
    x = _x(200, 64, 3)
    got = pcor_strip(torch.from_numpy(x), row_start, row_count).numpy()
    want = np.asarray(j_pcor_strip(x, row_start, row_count))
    assert got.shape == want.shape == (row_count, 200)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_pcor_strip_clamps_like_dynamic_slice():
    x = torch.from_numpy(_x(200, 64, 4))
    assert torch.equal(pcor_strip(x, 150, 100), pcor_strip(x, 100, 100))
    assert torch.equal(pcor_strip(x, -5, 10), pcor_strip(x, 0, 10))


def test_strips_tile_the_matrix():
    x = torch.from_numpy(_x(200, 64, 5))
    full = correlate(x)
    strips = torch.cat([pcor_strip(x, 0, 100), pcor_strip(x, 100, 100)])
    torch.testing.assert_close(strips, full, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(full, pcor_ref(x), rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernel_does_not_take():
    x = torch.zeros(10, 4)
    with pytest.raises(ValueError):
        pcor(torch.zeros(10))
    with pytest.raises(ValueError):
        pcor(torch.zeros(10, 4, dtype=torch.int32))
    with pytest.raises(ValueError):
        pcor(x, row_start=8, row_count=3)
    with pytest.raises(ValueError):
        pcor(torch.zeros(10, 0))
    with pytest.raises(ValueError, match="no kernel for device"):
        pcor(x.to("meta"))
    before = pcor.launches
    pcor(x)                       # the CPU route launches nothing
    assert pcor.launches == before


def _stored_by(g: int, row_start: int, row_count: int) -> np.ndarray:
    """For each element of the strip's (row_count, G) output, the pairs of
    ``plan`` that store it, as the kernel's epilogue stores: a pair (I, J)
    stores the strip's rows of tile I at the columns of tile J as computed
    and, when I < J, the strip's rows of tile J at the columns of tile I
    transposed.  -> (count, I, J) per element, of the last pair seen."""
    count = np.zeros((row_count, g), np.int64)
    who = np.full((2, row_count, g), -1, np.int64)
    rows = np.arange(row_start, row_start + row_count)

    def store(row_tile, col_tile, pair):
        sel = rows // TILE == row_tile
        cols = slice(col_tile * TILE, min(g, (col_tile + 1) * TILE))
        count[sel, cols] += 1
        who[0, sel, cols], who[1, sel, cols] = pair

    for pair in plan(g, row_start, row_count):
        i, j = pair
        store(i, j, pair)
        if i < j:
            store(j, i, pair)
    return count, who


@pytest.mark.parametrize("g,row_start,row_count", [
    (1, 0, 1), (127, 0, 127), (129, 0, 129), (301, 0, 301),
    (301, 172, 50),     # starts inside a tile, as SPRINT's 5500 does
    (301, 100, 200),    # crosses the diagonal tile of its own rows
    (301, 137, 1), (301, 300, 1), (301, 255, 2), (1001, 501, 500),
    (1001, 0, 501),     # SPRINT's two strips, at a smaller G
])
def test_plan_covers_every_element_once_by_its_canonical_pair(
        g, row_start, row_count):
    pairs = plan(g, row_start, row_count)
    assert len(pairs) == n_pairs(g, row_start, row_count)
    assert len(set(pairs)) == len(pairs)
    assert all(0 <= i <= j < -(-g // TILE) for i, j in pairs)
    count, who = _stored_by(g, row_start, row_count)
    assert (count == 1).all()
    i = np.arange(row_start, row_start + row_count)[:, None]
    j = np.arange(g)[None, :]
    assert (who[0] == np.minimum(i, j) // TILE).all()
    assert (who[1] == np.maximum(i, j) // TILE).all()


def test_full_matrix_plan_is_one_triangle():
    nt = -(-11_000 // TILE)
    assert plan(11_000, 0, 11_000) == [(i, j) for i in range(nt)
                                       for j in range(i, nt)]
    assert n_pairs(11_000, 0, 5_500) + n_pairs(11_000, 5_500, 5_500) \
        == nt * (nt + 1) // 2 + 43 * 44     # tile 42 holds rows of both


def _exec_workunits(x: torch.Tensor):
    """``chip_smoke.py``'s SPRINT flow (``benchmarks/fig4_sprint_pcor.py``'s
    two-volunteer work units through the scheduler), here on the CPU.
    -> (the assembled matrix, digests by unit)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    out, strips, digests, _ = smoke._sprint_exec(x, workers=2)
    assert sorted(strips) == [0, (x.shape[0] + 1) // 2]
    return out, digests


def test_sprint_workunits_match_reference():
    x = _x(600, 321, 6)
    out, digests = _exec_workunits(torch.from_numpy(x))
    np.testing.assert_allclose(out, np.asarray(j_correlate(
        x, mode="interpret")), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out, np.corrcoef(x), rtol=1e-4, atol=1e-4)
    again, digests2 = _exec_workunits(torch.from_numpy(x))
    assert digests2 == digests and np.array_equal(again, out)
