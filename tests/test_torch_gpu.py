"""The port on the card: CUDA paths against their CPU twins.

Marked ``gpu``: each test skips without a CUDA device.  On the card run
``python -m pytest -m gpu tests/test_torch_gpu.py``.  This file imports
no JAX, so it runs where only PyTorch is installed; the CPU side it
compares with is itself held against JAX by the other
``tests/test_torch_*.py`` files.  Tolerance: none, bit for bit, since the
probe is an integer XOR and the launcher is deterministic on the card.
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import tree as tu
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.kernels.delta_encode import ops
from repro_torch.kernels.delta_encode.kernel import (as_i32_tiles,
                                                     fused_delta_tiles)
from repro_torch.kernels.delta_encode.ref import fused_tiles_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaf(dtype: torch.dtype, n: int, gen: torch.Generator) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(n, generator=gen).to(dtype)
    return torch.randint(-1000, 1000, (n,), generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", ops.KERNEL_DTYPES)
def test_kernel_matches_plain_version(cuda, dtype):
    gen = torch.Generator().manual_seed(17)
    old = _leaf(ops.dtype_from_name(dtype), 3 * 16384 + 11, gen)
    new = old.clone()
    bits = new.view(torch.int16 if new.element_size() == 2 else torch.int32)
    bits[[0, 2 * 16384 + 5]] ^= 1
    o32, _ = as_i32_tiles(old.to(cuda))
    n32, _ = as_i32_tiles(new.to(cuda))
    before = fused_delta_tiles.launches
    bm, tiles = fused_delta_tiles(o32, n32)
    assert fused_delta_tiles.launches == before + 1
    bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
    torch.cuda.synchronize()
    k = int(bm_ref.sum())
    assert k >= 1
    assert torch.equal(bm, bm_ref) and torch.equal(tiles[:k], tiles_ref)


def _tree(gen) -> dict:
    return {"tiny": torch.randn(500, generator=gen),
            "whole": torch.randn(8192 * 3, generator=gen),
            "mid": torch.randn(33000, generator=gen),
            "half": torch.randn(4097, generator=gen).half(),
            "idx": torch.randint(0, 9, (77,), generator=gen,
                                 dtype=torch.int32)}


@pytest.mark.parametrize("bucketed", [True, False])
def test_probe_leaves_matches_cpu(cuda, bucketed):
    gen = torch.Generator().manual_seed(3)
    cpu = _tree(gen)
    dev = {k: v.to(cuda) for k, v in cpu.items()}
    mc, md = ops.DeviceMirror(), ops.DeviceMirror()
    for rnd in range(3):
        if rnd:
            for tree in (cpu, dev):        # the same in-place updates
                tree["whole"][8192 + 7] += 1.0
                tree["mid"].add_(0.5)
                tree["half"][4096] = 3.0
        want = ops.probe_leaves(cpu, mirror=mc, bucketed=bucketed)
        got = ops.probe_leaves(dev, mirror=md, bucketed=bucketed)
        assert got.keys() == want.keys()
        for key, w in want.items():
            if w is None:
                assert got[key] is None
                continue
            np.testing.assert_array_equal(got[key][0], w[0])
            np.testing.assert_array_equal(got[key][1], w[1])
        if rnd:
            assert got["whole"][1].tolist() == [0, 1, 0]
            assert not got["tiny"][1].any()


def test_snapshot_manifests_and_restore_match_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    states = [_tree(gen)]
    for _ in range(2):
        nxt = {k: v.clone() for k, v in states[-1].items()}
        nxt["mid"][100:200] += 1.0
        nxt["whole"][-1] = 0.0
        states.append(nxt)
    mans = []
    for device in ("cpu", cuda):
        mgr = SnapshotManager(ChunkStore(chunk_bytes=1 << 15), keep_last=5)
        for i, st in enumerate(states):
            mgr.snapshot(tu.tree_map(lambda t: t.to(device), st), step=i)
        out, _ = mgr.restore(device=device)
        for key, t in tu.flatten_with_keys(states[-1]):
            assert out[key].device.type == torch.device(device).type
            assert torch.equal(out[key].cpu(), t)
        dicts = [json.loads(mgr.manifests[s].to_json()) for s in mgr.order]
        mans.append([{k: v for k, v in d.items() if k != "created"}
                     for d in dicts])
        mgr.close()
    assert mans[0] == mans[1]


def test_launcher_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    from repro_torch.launch import train
    out = str(tmp_path / "run")
    a = train.main(["--steps", "4", "--snapshot-every", "2", "--outdir",
                    out])
    r = train.main(["--steps", "2", "--snapshot-every", "2", "--outdir",
                    out, "--resume"])
    full = train.main(["--steps", "6", "--snapshot-every", "2"])
    assert a["device"].startswith("cuda")
    assert a["losses"] + r["losses"] == full["losses"]
