"""Port parity for the one-shot delta API: ``diff_blocks``,
``patch_blocks`` and both routes of ``changed_blocks``.

On the CPU the wrappers take their plain versions (``changed_bitmap_ref``,
``delta_encode_ref``, ``delta_apply_ref``, ``fused_tiles_ref``); these are
held against the JAX package's ops in Pallas interpret mode and in its
numpy ``ref`` mode.  Tolerance: none, bit for bit: every step is an
integer XOR or a copy, with no rounding anywhere, so NaN payloads,
infinities and signed zeros must come back as they went in.  The CUDA
kernels are held against the plain versions on the card
(``tests/test_torch_gpu.py`` and ``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_encode import ops as jops
from repro_torch.kernels.delta_encode import ops
from repro_torch.kernels.delta_encode.kernel import (_bitcast_back,
                                                     as_i32_tiles,
                                                     changed_bitmap,
                                                     delta_apply,
                                                     delta_encode,
                                                     gather_delta)
from repro_torch.kernels.delta_encode.ref import (changed_bitmap_ref,
                                                  delta_apply_ref,
                                                  delta_encode_ref)


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> CPU tensor, same bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _bytes(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _assert_diff_parity(old: np.ndarray, new: np.ndarray,
                        interpret: bool = True) -> None:
    """Port diff/patch == JAX interpret (kernel dtypes) and ref mode."""
    tiles, bitmap, n = ops.diff_blocks(_t(old), _t(new))
    r_tiles, r_bitmap, _ = jops.diff_blocks(old, new, mode="ref")
    np.testing.assert_array_equal(bitmap, r_bitmap)
    np.testing.assert_array_equal(tiles, r_tiles)
    assert tiles.dtype == np.int32 and bitmap.dtype == np.int32
    if interpret:
        j_tiles, j_bitmap, j_n = jops.diff_blocks(old, new,
                                                  mode="interpret")
        np.testing.assert_array_equal(bitmap, j_bitmap)
        np.testing.assert_array_equal(tiles, j_tiles)
        assert n == j_n
    rec = ops.patch_blocks(_t(old), tiles, bitmap)
    assert rec.shape == tuple(old.shape) and rec.dtype == _t(old).dtype
    np.testing.assert_array_equal(_bytes(rec), _bytes(new))
    for mode in ("ref",) + (("interpret",) if interpret else ()):
        want = jops.patch_blocks(old, tiles, bitmap, mode=mode)
        np.testing.assert_array_equal(_bytes(rec), _bytes(want))


@pytest.mark.parametrize("dtype,shape", [
    (np.float32, (1000, 517)), (np.float32, (8192,)),
    (np.int32, (3, 8193)), (np.float32, (7,)),
])
def test_diff_patch_matches_reference(dtype, shape):
    """``tests/test_kernels.py``'s round-trip cases."""
    rng = np.random.default_rng(sum(shape))
    if dtype == np.float32:
        old = rng.standard_normal(shape).astype(dtype)
    else:
        old = rng.integers(-2 ** 30, 2 ** 30, shape).astype(dtype)
    new = old.copy()
    flat = new.reshape(-1)
    idx = rng.choice(flat.size, size=max(1, flat.size // 50), replace=False)
    flat[idx] = flat[idx] * 2 + 1
    _assert_diff_parity(old, new)


def test_diff_patch_nan_inf_signed_zero_exact():
    old = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0] * 2000, np.float32)
    old[1::5] = np.frombuffer(np.uint32(0x7fc00123).tobytes(), np.float32)
    new = old.copy()
    new[::7] = 1.5
    new[3::11] = -0.0
    _assert_diff_parity(old, new)


def test_diff_unchanged_is_empty():
    x = np.ones(30_000, np.float32)
    tiles, bitmap, _ = ops.diff_blocks(_t(x), _t(x))
    assert tiles.shape == (0, 8, 1024) and bitmap.sum() == 0
    _assert_diff_parity(x, x.copy())


@pytest.mark.parametrize("dtype", ops.KERNEL_DTYPES)
def test_diff_patch_every_kernel_dtype_odd_count(dtype):
    rng = np.random.default_rng(7)
    size = 2 * 8192 + 777           # odd: a 16-bit leaf pads a half-word
    base = rng.integers(-1000, 1000, size)
    old = np.asarray(jnp.asarray(base).astype(dtype))
    new = old.copy()
    idx = np.concatenate([rng.integers(0, size, 5), [size - 1]])
    new[idx] = np.asarray(jnp.asarray(base[idx] + 7).astype(dtype))
    _assert_diff_parity(old, new)


@pytest.mark.parametrize("dtype", ["float64", "int8", "uint8", "int64"])
def test_diff_patch_byte_view_dtypes_match_ref_mode(dtype):
    """Dtypes the kernels do not bitcast go through them on a byte view;
    the reference's numpy oracle diffs the same bytes."""
    rng = np.random.default_rng(8)
    old = rng.integers(0, 100, 9001).astype(dtype)
    new = old.copy()
    new[[0, 4000, 9000]] += 3
    _assert_diff_parity(old, new, interpret=False)


def _changed_cases():
    rng = np.random.default_rng(9)
    f32 = rng.standard_normal(70000).astype(np.float32)
    f32_new = f32.copy()
    f32_new[rng.integers(0, f32.size, 30)] = 2.5
    bf = np.asarray(jnp.asarray(rng.standard_normal(20001))
                    .astype("bfloat16"))
    bf_new = bf.copy()
    bf_new[[5, 20000]] = bf_new[[5, 20000]] * 2 + 1
    f64 = rng.standard_normal(5000)
    f64_new = f64.copy()
    f64_new[4999] = 0.0
    return {"float32": (f32, f32_new), "float32_same": (f32, f32.copy()),
            "bfloat16_odd": (bf, bf_new), "float64": (f64, f64_new)}


@pytest.mark.parametrize("case", ["float32", "float32_same", "bfloat16_odd",
                                  "float64"])
def test_changed_blocks_routes_agree_with_reference(case):
    old, new = _changed_cases()[case]
    got = {fused: ops.changed_blocks(_t(old), _t(new), fused=fused)
           for fused in (True, False)}
    want = jops.changed_blocks(old, new, mode="ref", fused=False)
    for tiles, bitmap, nbytes in got.values():
        np.testing.assert_array_equal(tiles, want[0])
        np.testing.assert_array_equal(bitmap, want[1])
        assert nbytes == want[2]
    chunk = 1 << 14
    want_r, want_flat, _ = jops.changed_blocks(old, new, mode="ref",
                                               fused=False, emit="records",
                                               chunk_bytes=chunk)
    for fused in (True, False):
        records, new_flat, nbytes = ops.changed_blocks(
            _t(old), _t(new), fused=fused, emit="records",
            chunk_bytes=chunk)
        assert records == want_r and nbytes == old.nbytes
        np.testing.assert_array_equal(new_flat, want_flat)
        np.testing.assert_array_equal(new_flat, _bytes(new))


@pytest.mark.parametrize("changed", [True, False])
def test_kernel_stats_count_launches_as_the_reference(changed):
    old = np.arange(3 * 8192 + 5, dtype=np.float32)
    new = old.copy()
    if changed:
        new[[10, 2 * 8192]] += 1.0
    counts = {}
    for fused in (True, False):
        jops.reset_kernel_stats()
        jops.changed_blocks(old, new, mode="interpret", fused=fused)
        ops.reset_kernel_stats()
        tiles, bitmap, _ = ops.changed_blocks(_t(old), _t(new), fused=fused)
        counts[fused] = ops.KERNEL_STATS["launches"]
        assert counts[fused] == jops.KERNEL_STATS["launches"]
        # exactly the bitmap and the k changed tiles leave the device
        assert ops.KERNEL_STATS["d2h_bytes"] == bitmap.nbytes + tiles.nbytes
    assert counts == {True: 1, False: 1 + changed}
    ops.reset_kernel_stats()
    jops.reset_kernel_stats()


def test_changed_blocks_mirror_matches_reference():
    rng = np.random.default_rng(10)
    rounds = [rng.standard_normal(20000).astype(np.float32)]
    for i in range(3):
        nxt = rounds[-1].copy()
        nxt[rng.integers(0, nxt.size, 3 * i)] = 4.0
        rounds.append(nxt)
    jm, tm = jops.DeviceMirror(), ops.DeviceMirror()
    for old, new in zip(rounds, rounds[1:]):
        want = jops.changed_blocks(old, new, mode="interpret", mirror=jm,
                                   mirror_key="w")
        got = ops.changed_blocks(_t(old), _t(new), mirror=tm,
                                 mirror_key="w")
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
    assert len(tm) == 1


@pytest.mark.parametrize("size", [8192 * 2, 9000])
def test_changed_blocks_mirror_sees_an_in_place_update(size):
    """The slot owns its bytes: an ``add_`` on the leaf between two
    mirrored calls shows in the second diff.  Kept by reference, a
    whole-tile float32 leaf's slot would alias the leaf and read zero."""
    leaf = torch.zeros(size, dtype=torch.float32)
    mirror = ops.DeviceMirror()
    ops.changed_blocks(leaf.clone(), leaf, mirror=mirror, mirror_key="a")
    before = leaf.clone()
    leaf[123:125].add_(5.0)
    tiles, bitmap, _ = ops.changed_blocks(before, leaf, mirror=mirror,
                                          mirror_key="a")
    assert bitmap.tolist() == [1] + [0] * (len(bitmap) - 1)
    assert tiles.shape[0] == 1 and tiles.any()
    # the mirror, not ``old``, was diffed: a stale old changes nothing
    leaf.add_(1.0)
    tiles, bitmap, _ = ops.changed_blocks(torch.zeros(size), leaf,
                                          mirror=mirror, mirror_key="a")
    assert bitmap.all()
    want = torch.bitwise_xor(*(as_i32_tiles(t)[0]
                               for t in (leaf - 1.0, leaf)))
    np.testing.assert_array_equal(tiles, want.numpy())


def test_plain_versions_agree_with_each_other():
    rng = np.random.default_rng(11)
    o32 = torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31 - 1,
                                        (5, 8, 1024)).astype(np.int32))
    n32 = o32.clone()
    n32[1, 3, 7] ^= 1
    n32[4, 7, 1023] ^= -2 ** 31
    bm = changed_bitmap(o32, n32)
    delta, bm2 = delta_encode(o32, n32)
    assert bm.tolist() == [0, 1, 0, 0, 1] and torch.equal(bm, bm2)
    assert torch.equal(bm, changed_bitmap_ref(o32, n32))
    assert torch.equal(delta, delta_encode_ref(o32, n32)[0])
    assert torch.equal(delta_apply(o32, delta), n32)
    assert torch.equal(delta_apply_ref(o32, delta), n32)
    idx = torch.tensor([1, 4])
    assert torch.equal(gather_delta(o32, n32, idx), delta[idx])


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.int16, torch.float32, torch.int32])
def test_bitcast_back_drops_the_padding(dtype):
    x = torch.arange(8193).to(dtype).reshape(3, 2731)
    tiles, _ = as_i32_tiles(x)
    back = _bitcast_back(tiles.reshape(-1), x.shape, x.dtype)
    assert back.shape == x.shape and back.dtype == dtype
    np.testing.assert_array_equal(_bytes(back), _bytes(x))


def test_bad_pairs_raise():
    a = torch.zeros(100)
    with pytest.raises(TypeError):
        ops.changed_blocks(a, a.double())
    with pytest.raises(TypeError):
        ops.diff_blocks(a, a.int())
    with pytest.raises(ValueError):
        ops.changed_blocks(a, a, emit="bytes")
    with pytest.raises(ValueError, match="chunk_bytes"):
        ops.changed_blocks(a, a, emit="records")
    t = torch.zeros((2, 8, 1024), dtype=torch.int32)
    with pytest.raises(ValueError):
        delta_apply(t, t[:1])
    with pytest.raises(ValueError):
        changed_bitmap(t, t.float())
    with pytest.raises(ValueError, match="no kernel for device"):
        delta_encode(t.to("meta"), t.to("meta"))
