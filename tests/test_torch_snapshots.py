"""Port parity for differencing snapshots.

The same state bytes, snapshotted step after step by the JAX
``SnapshotManager`` (``delta_mode="ref"``) and by the port's, give the same
manifests: keys in the same order, shapes, numpy dtype names, per-chunk
refs, parents, kinds and aux — everything but the ``created`` clock, inline
and async.  A chain written by either framework into the shared on-disk
store restores bit-exactly in the other.  Tolerance: none, bit for bit.
"""
from __future__ import annotations

import json

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, reduced
from repro.core.chunkstore import ChunkStore as JChunkStore
from repro.core.snapshots import SnapshotManager as JSnapshotManager
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.optim.adamw import AdamWState
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.snapshots import SnapshotManager

CHUNK = 1 << 15          # small store chunks so diffs touch a few of many


def _train_state_flat() -> dict:
    """Keystr-keyed numpy leaves of a JAX-initialised reduced granite
    TrainState (params, opt.step, opt.m, opt.v)."""
    cfg = reduced(get_arch("granite-3-2b"), vocab_size=300)
    specs = japi.state_specs(cfg)
    state = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                            j_init_tree(specs.opt, jax.random.key(1)))
    return {k: np.asarray(v) for k, v in j_flatten(state)}


def _mixed_flat() -> dict:
    rng = np.random.default_rng(5)
    bf16 = np.asarray(jax.numpy.asarray(rng.standard_normal(9001))
                      .astype("bfloat16"))
    return {"['a']": rng.standard_normal((40, 300)).astype(np.float32),
            "['b']['h']": rng.standard_normal(4097).astype(np.float16),
            "['b']['w']": bf16,
            "['c']": rng.integers(-9, 9, 77).astype(np.int16),
            "['d']": np.asarray(7, np.int32)}


def _steps(flat: dict, n: int) -> list:
    """n successive states: each changes a few elements of a few leaves."""
    rng = np.random.default_rng(9)
    out = [flat]
    for i in range(1, n):
        cur = {k: v.copy() for k, v in out[-1].items()}
        for j, key in enumerate(sorted(cur)):
            if (i + j) % 3 and cur[key].size:
                a = cur[key].reshape(-1)
                idx = rng.integers(0, a.size, 3)
                a[idx] = (a[idx].astype(np.float32) + 1).astype(a.dtype)
        out.append(cur)
    return out


def _nest(flat: dict) -> dict:
    out: dict = {}
    for key, arr in flat.items():
        parts = tu.parse_keystr(key)
        node = out
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr
    return out


def _jax_tree(flat: dict):
    """The JAX-side tree the flat keys came from (TrainState or dicts)."""
    t = _nest(flat)
    if "opt" not in t:
        return t
    o = t["opt"]
    return japi.TrainState(t["params"], AdamWState(o["step"], o["m"], o["v"]))


def _torch_tree(flat: dict):
    if any(k.startswith(".opt") for k in flat):
        return convert.state_from_numpy(flat, "cpu")
    return convert.tree_from_numpy(flat, "cpu")


def _manifest_dicts(mgr) -> list:
    out = []
    for sid in mgr.order:
        d = json.loads(mgr.manifests[sid].to_json())
        d.pop("created")
        out.append(d)
    return out


@pytest.mark.parametrize("async_mode", [False, True])
@pytest.mark.parametrize("which", ["train_state", "mixed_dtypes"])
def test_manifests_equal_reference(which, async_mode):
    flat = _train_state_flat() if which == "train_state" else _mixed_flat()
    seq = _steps(flat, 4)
    jm = JSnapshotManager(JChunkStore(chunk_bytes=CHUNK), keep_last=10,
                          async_mode=async_mode, delta_mode="ref")
    tm = SnapshotManager(ChunkStore(chunk_bytes=CHUNK), keep_last=10,
                         async_mode=async_mode)
    for i, st in enumerate(seq):
        jm.snapshot(_jax_tree(st), step=i, aux={"round": i}, block=True)
        tm.snapshot(_torch_tree(st), step=i, aux={"round": i}, block=True)
    jm.close()
    tm.close()
    want, got = _manifest_dicts(jm), _manifest_dicts(tm)
    assert [list(d["tensors"]) for d in got] == \
        [list(d["tensors"]) for d in want]
    assert got == want
    assert [d["kind"] for d in got] == ["base", "diff", "diff", "diff"]
    restored, _ = tm.restore()
    for key, arr in seq[-1].items():
        np.testing.assert_array_equal(
            convert.state_to_numpy({"x": restored[key]})["['x']"], arr)


def _write_chain(mgr, trees) -> None:
    for i, tree in enumerate(trees):
        mgr.snapshot(tree, step=i, aux={"round": i}, block=True)
    mgr.close()


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_chain_restores_across_frameworks(writer, tmp_path):
    flat = _mixed_flat()
    seq = _steps(flat, 3)
    store, snaps = tmp_path / "store", tmp_path / "snaps"
    if writer == "jax":
        _write_chain(JSnapshotManager(JChunkStore(store, chunk_bytes=CHUNK),
                                      root=snaps, delta_mode="ref"),
                     [_jax_tree(s) for s in seq])
        reader = SnapshotManager(ChunkStore(store, chunk_bytes=CHUNK),
                                 root=snaps)
        reader.load_existing()
        state, aux = reader.restore(target_tree=_torch_tree(seq[0]))
        got = convert.state_to_numpy(state)
    else:
        _write_chain(SnapshotManager(ChunkStore(store, chunk_bytes=CHUNK),
                                     root=snaps),
                     [_torch_tree(s) for s in seq])
        reader = JSnapshotManager(JChunkStore(store, chunk_bytes=CHUNK),
                                  root=snaps, delta_mode="ref")
        reader.load_existing()
        got, aux = reader.restore()
    assert aux == {"round": 2}
    assert list(got) == list(seq[-1])
    for key, want in seq[-1].items():
        assert got[key].dtype == want.dtype and got[key].shape == want.shape
        assert got[key].tobytes() == want.tobytes(), key


def test_convert_round_trip_is_exact():
    flat = _train_state_flat()
    state = convert.state_from_numpy(flat, "cpu")
    assert isinstance(state.opt.step, torch.Tensor)
    back = convert.state_to_numpy(state)
    assert list(back) == list(flat)
    for key in flat:
        np.testing.assert_array_equal(back[key], flat[key])


def test_untouched_state_snapshots_without_a_launch():
    """Snapshotting the same, untouched tensors again skips the probe and
    reuses every chunk; an in-place write to one leaf is picked up."""
    from repro_torch.kernels.delta_encode import ops
    state = _torch_tree(_mixed_flat())
    mgr = SnapshotManager(ChunkStore(chunk_bytes=CHUNK))
    mgr.snapshot(state, step=0)
    mgr.snapshot(state, step=1)          # seeds the second mirror image
    ops.reset_kernel_stats()
    info = mgr.snapshot(state, step=2)
    assert ops.KERNEL_STATS["launches"] == 0 and info.changed_chunks == 0
    state["a"][3, 7] += 1.0
    info = mgr.snapshot(state, step=3)
    assert ops.KERNEL_STATS["launches"] == 1 and info.changed_chunks == 1
    restored, _ = mgr.restore()
    assert torch.equal(restored["['a']"], state["a"])
    ops.reset_kernel_stats()
