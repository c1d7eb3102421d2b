"""Port parity for the fused delta probe.

The port's plain version (``fused_tiles_ref``, the route of every CPU
tensor) and its ``probe_leaves`` are held against the JAX package's
``fused_delta_tiles`` in Pallas interpret mode and its
``probe_leaves(mode="ref")``.  Tolerance: none, bit for bit — the probe is
an integer XOR with no rounding anywhere.  The CUDA kernel itself is held
against the plain version on the card (``tests/test_torch_gpu.py``, and
``chip_smoke.py``).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.delta_encode import ops as jops
from repro.kernels.delta_encode.kernel import as_i32_tiles as j_as_i32_tiles
from repro.kernels.delta_encode.kernel import \
    fused_delta_tiles as j_fused_delta_tiles
from repro_torch.kernels.delta_encode import ops
from repro_torch.kernels.delta_encode.kernel import (as_i32_tiles,
                                                     fused_delta_tiles)
from repro_torch.kernels.delta_encode.ref import fused_tiles_ref


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy (ml_dtypes bfloat16 included) -> CPU tensor, same bytes."""
    a = np.ascontiguousarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a.copy())


def _mutate(arr: np.ndarray, idx, rng) -> np.ndarray:
    out = arr.copy()
    if np.issubdtype(out.dtype, np.integer):
        out[idx] = out[idx] + 1
    else:
        out[idx] = (rng.standard_normal(len(idx)) + 2.0).astype(out.dtype)
    return out


def _assert_tiles_parity(old: np.ndarray, new: np.ndarray) -> None:
    """Port tile views + plain probe == JAX views + interpret kernel."""
    jo, jn_count = j_as_i32_tiles(jnp.asarray(old))
    jn, _ = j_as_i32_tiles(jnp.asarray(new))
    to, tn_count = as_i32_tiles(_t(old))
    tn, _ = as_i32_tiles(_t(new))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    assert int(tn_count) == int(jn_count)
    jbm, jtiles = j_fused_delta_tiles(jo, jn, interpret=True)
    tbm, ttiles = fused_delta_tiles(to, tn)
    jbm = np.asarray(jbm)
    np.testing.assert_array_equal(tbm.numpy(), jbm)
    k = int(jbm.sum())
    np.testing.assert_array_equal(ttiles[:k].numpy(), np.asarray(jtiles)[:k])


TAIL_SIZES = (1000, 8192 * 3 + 5, 70000)


@pytest.mark.parametrize("size", TAIL_SIZES)
def test_fused_parity_tail_tiles(size):
    rng = np.random.default_rng(size)
    old = rng.standard_normal(size).astype(np.float32)
    _assert_tiles_parity(old, _mutate(old, rng.integers(0, size, 17), rng))


@pytest.mark.parametrize("dtype", ops.KERNEL_DTYPES)
def test_fused_parity_every_kernel_dtype(dtype):
    rng = np.random.default_rng(3)
    size = 8192 + 777               # one whole tile + ragged (odd) tail
    base = rng.integers(-1000, 1000, size)
    old = np.asarray(jnp.asarray(base).astype(dtype))
    new = old.copy()
    idx = rng.integers(0, size, 9)
    new[idx] = np.asarray(jnp.asarray(base[idx] + 7).astype(dtype))
    _assert_tiles_parity(old, new)


def test_fused_parity_empty_bitmap():
    old = np.arange(20000, dtype=np.int32)
    o32, _ = as_i32_tiles(_t(old))
    bm, tiles = fused_tiles_ref(o32, o32.clone())
    assert int(bm.sum()) == 0 and tiles.shape == (0, 8, 1024)
    _assert_tiles_parity(old, old.copy())


def test_fused_parity_all_changed():
    old = np.arange(8192 * 2 + 123, dtype=np.int32)
    new = old + 1
    o32, _ = as_i32_tiles(_t(old))
    n32, _ = as_i32_tiles(_t(new))
    assert bool(fused_tiles_ref(o32, n32)[0].all())
    _assert_tiles_parity(old, new)


# ---------------------------------------------------------------- probe


def _tree(rng) -> dict:
    # several size classes so leaves land in different pow2 buckets
    return {
        "tiny": rng.standard_normal(500).astype(np.float32),
        "small": rng.standard_normal(9000).astype(np.float32),
        "mid_a": rng.standard_normal(33000).astype(np.float32),
        "mid_b": rng.standard_normal(33000).astype(np.float32),
        "big": rng.standard_normal(131072).astype(np.float32),
        "half": rng.standard_normal(4097).astype(np.float16),
        "idx": rng.integers(0, 9, 77).astype(np.int32),
    }


def _assert_probe_equal(port: dict, ref: dict) -> None:
    assert port.keys() == ref.keys()
    for key, want in ref.items():
        got = port[key]
        if want is None:
            assert got is None, key
            continue
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[1], want[1])
        assert got[2] == want[2]


@pytest.mark.parametrize("bucketed", [True, False])
def test_probe_leaves_matches_reference(bucketed):
    rng = np.random.default_rng(11)
    rounds = [_tree(rng)]
    for _ in range(2):
        rounds.append({k: (_mutate(v, rng.integers(0, v.size, 5), rng)
                           if k in ("small", "big", "half") else v.copy())
                       for k, v in rounds[-1].items()})
    jm, tm = jops.DeviceMirror(), ops.DeviceMirror()
    for i, tree in enumerate(rounds):
        want = jops.probe_leaves(tree, mode="ref", mirror=jm,
                                 bucketed=bucketed)
        got = ops.probe_leaves({k: _t(v) for k, v in tree.items()},
                               mirror=tm, bucketed=bucketed)
        _assert_probe_equal(got, want)
        assert all(v is None for v in got.values()) == (i == 0)


def test_probe_bucketed_equals_per_leaf():
    rng = np.random.default_rng(12)
    t0 = {k: _t(v) for k, v in _tree(rng).items()}
    t1 = {k: _t(_mutate(v.numpy(), rng.integers(0, v.numel(), 3), rng))
          for k, v in t0.items()}
    mb, ml = ops.DeviceMirror(), ops.DeviceMirror()
    ops.probe_leaves(t0, mirror=mb, bucketed=True)
    ops.probe_leaves(t0, mirror=ml, bucketed=False)
    rb = ops.probe_leaves(t1, mirror=mb, bucketed=True)
    rl = ops.probe_leaves(t1, mirror=ml, bucketed=False)
    _assert_probe_equal(rb, rl)


def test_probe_launches_o_buckets_not_o_leaves():
    rng = np.random.default_rng(13)
    tree = {f"l{i:02d}": _t(rng.standard_normal(9000).astype(np.float32))
            for i in range(24)}              # 24 leaves, ONE size bucket
    mirror = ops.DeviceMirror()
    ops.probe_leaves(tree, mirror=mirror)
    nxt = {k: v + 1.0 for k, v in tree.items()}
    ops.reset_kernel_stats()
    ops.probe_leaves(nxt, mirror=mirror)
    assert ops.KERNEL_STATS["launches"] == 1
    ops.reset_kernel_stats()


def test_probe_layout_change_rebases_bucket():
    rng = np.random.default_rng(15)
    a = rng.standard_normal(9000).astype(np.float32)
    b = rng.standard_normal(9000).astype(np.float32)
    rounds = [{"a": a, "b": b},
              {"a": a[:4500].copy(), "b": b.copy()},
              {"a": a[:4500].copy(), "b": _mutate(b, [7], rng)}]
    jm, tm = jops.DeviceMirror(), ops.DeviceMirror()
    results = []
    for tree in rounds:
        want = jops.probe_leaves(tree, mode="ref", mirror=jm)
        got = ops.probe_leaves({k: _t(v) for k, v in tree.items()},
                               mirror=tm)
        _assert_probe_equal(got, want)
        results.append(got)
    assert results[1]["a"] is None           # shape changed -> re-base
    assert results[2]["b"] is not None and results[2]["b"][1].any()


def test_probe_identity_fast_path_skips_untouched_tensors():
    rng = np.random.default_rng(14)
    tree = {k: _t(v) for k, v in _tree(rng).items()}
    mirror = ops.DeviceMirror()
    ops.probe_leaves(tree, mirror=mirror)
    ops.reset_kernel_stats()
    res = ops.probe_leaves(tree, mirror=mirror)      # same, untouched
    assert ops.KERNEL_STATS["launches"] == 0
    assert all(not r[1].any() for r in res.values())
    ops.reset_kernel_stats()


@pytest.mark.parametrize("size,max_bucket", [
    (8192 * 2, 256),      # whole-tile leaf in a bucket: tile view aliases it
    (8192 * 2, 1),        # the same leaf on its own launch
    (9000, 256),          # padded leaf: the tile view is a copy
])
def test_probe_detects_in_place_update(size, max_bucket):
    """An in-place ``add_`` between probes must show up in the diff: the
    slot owns its bytes and the skip checks the version counter."""
    leaf = torch.zeros(size, dtype=torch.float32)
    other = torch.ones(9000, dtype=torch.float32)
    mirror = ops.DeviceMirror()
    tree = {"a": leaf, "b": other}
    assert ops.probe_leaves(tree, mirror=mirror,
                            max_bucket_tiles=max_bucket)["a"] is None
    leaf[123:125].add_(5.0)                  # same object, new bytes
    tiles, bitmap, _ = ops.probe_leaves(tree, mirror=mirror,
                                        max_bucket_tiles=max_bucket)["a"]
    assert bitmap.tolist() == [1] + [0] * (len(bitmap) - 1)
    assert tiles.shape[0] == 1 and tiles.any()
    leaf.add_(1.0)                            # every tile changes
    tiles, bitmap, _ = ops.probe_leaves(tree, mirror=mirror,
                                        max_bucket_tiles=max_bucket)["a"]
    assert bitmap.all() and tiles.shape[0] == len(bitmap)


def test_dtype_names_are_numpy_names():
    assert ops.leaf_meta(torch.zeros(3, dtype=torch.float32))[2] == "float32"
    assert ops.leaf_meta(torch.zeros(3, dtype=torch.bfloat16))[2] == \
        "bfloat16"
    assert ops.dtype_from_name("int16") is torch.int16


def test_chunk_records_and_apply_tiles_match_reference():
    rng = np.random.default_rng(16)
    prev = rng.standard_normal(70000).astype(np.float32)
    new = _mutate(prev, rng.integers(0, prev.size, 30), rng)
    bm, tiles = fused_tiles_ref(as_i32_tiles(_t(prev))[0],
                                as_i32_tiles(_t(new))[0])
    bm, tiles = bm.numpy(), tiles.numpy()
    got = ops.chunk_records(prev, tiles, bm, prev.nbytes, 1 << 16)
    want = jops.chunk_records(prev, tiles, bm, prev.nbytes, 1 << 16)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[1].view(np.float32), new)
