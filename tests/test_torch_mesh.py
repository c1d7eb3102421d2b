"""The port's cells on a real mesh: 4 gloo ranks on the CPU, a (2, 2)
("data", "model") ``DeviceMesh``, started by
``torch.multiprocessing.spawn`` and meeting at a ``FileStore`` in a
temporary directory (no TCP port, so test workers do not collide).

The rank bodies live in ``tests/torch_mesh_worker.py``.  One spawn runs
a whole suite of checks (each rank's DTensor sharding propagation is
worked out once per process and then cached, most of a first step's
time), and each check is a test case here.  Tolerances: float32 compute
within 1e-5 of the largest value compared and 1e-5 relative, a bf16 cache
leaf within one bf16 step, as ``tests/test_torch_launch.py`` holds them
(the worker's ``state_matches`` says how an updated state is held).

The reference's own cell runs on its own (2, 2) CPU mesh in a process
of its own (``tests/jax_mesh_cell.py``, four XLA host devices, ``Auto``
axes), and the dry run over the ``fake`` backend in another.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch.multiprocessing as mp

from repro.core.capsule import CapsuleSpec as JCapsuleSpec
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.models.lm import RunConfig as JRunConfig

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
import torch_mesh_worker as worker  # noqa: E402

SPAWN_TIMEOUT = 600


def _src_env(**extra) -> dict:
    env = dict(os.environ, **extra)
    src = str(HERE.parent / "src")
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _spawn(tmp: Path, suite: str, *args) -> dict:
    """Run ``suite`` on 4 ranks -> {check: "ok" or its traceback}."""
    out = tmp / f"{suite}.json"
    ctx = mp.spawn(worker.checks, nprocs=worker.WORLD, join=False,
                   args=(str(tmp / f"{suite}.store"), str(out), suite)
                   + args)
    deadline = time.monotonic() + SPAWN_TIMEOUT
    while not ctx.join(timeout=5):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"suite {suite} ran past {SPAWN_TIMEOUT} s")
    return json.loads(out.read_text())


@pytest.fixture(scope="module")
def cell_results(tmp_path_factory):
    return _spawn(tmp_path_factory.mktemp("cells"), "cells")


@pytest.fixture(scope="module")
def misc_results(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("misc")
    ref = tmp / "reference.npz"
    subprocess.run(
        [sys.executable, str(HERE / "jax_mesh_cell.py"), str(ref), "8", "4"],
        check=True, timeout=SPAWN_TIMEOUT, env=_src_env(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4"))
    return tmp, _spawn(tmp, "misc", str(ref), str(tmp))


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("arch", worker.FAMILIES)
def test_sharded_cells_equal_the_unsharded(cell_results, arch, fsdp):
    """Reduced granite-3-2b, deepseek-moe-16b, falcon-mamba-7b and
    seamless-m4t-medium at float32: the (2, 2) mesh's train, prefill and
    decode cells (with ``fsdp_gather_weights`` and without) give the
    one-device cells' loss, logits, updated state and caches."""
    assert cell_results[f"{arch}:{fsdp}"] == "ok", \
        cell_results[f"{arch}:{fsdp}"]


def test_mesh_cell_equals_the_references_mesh_cell(misc_results):
    """granite's train loss and prefill logits on the port's (2, 2) mesh
    equal the reference's on its own, from the reference's state."""
    _, res = misc_results
    assert res["reference"] == "ok", res["reference"]


def test_capsule_boots_on_a_mesh(misc_results):
    """``boot(spec, mesh)`` describes the mesh as the reference does, its
    manifest hash is the reference's, and its step on placed state is the
    one-device capsule's."""
    tmp, res = misc_results
    assert res["capsule"] == "ok", res["capsule"]
    got = json.loads((tmp / "capsule.json").read_text())
    import jax.numpy as jnp
    want = JCapsuleSpec("granite-3-2b", "train_4k",
                        JRunConfig(compute_dtype=jnp.float32),
                        arch_override=j_reduced(j_get_arch("granite-3-2b")))
    assert got == {"hash": want.manifest_hash, "desc": "2x2:data,model"}


def test_unsharded_snapshot_restores_onto_a_mesh(misc_results):
    _, res = misc_results
    assert res["snapshot"] == "ok", res["snapshot"]


def test_traced_collectives_counts_an_fsdp_gather(misc_results):
    _, res = misc_results
    assert res["collectives"] == "ok", res["collectives"]


@pytest.fixture(scope="module")
def meta_flops(tmp_path_factory):
    out = tmp_path_factory.mktemp("flops") / "flops.json"
    mp.spawn(worker.flops_on_meta, args=(str(out),), nprocs=1)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", worker.FLOP_ARCHS)
def test_sharded_trace_counts_the_global_flops(meta_flops, arch):
    """``FlopCounterMode`` over a (2, 2) mesh's meta DTensors counts each
    cell's global FLOPs once, forward and backward, with the kernels'
    meta routes and the local attention and scan twins scaled to their
    shards: the unsharded cell's count, by the peak each runs at."""
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        (sharded, _), (whole, _) = meta_flops[f"{arch}:{shape_name}"]
        assert sharded == whole, shape_name
        assert whole["bfloat16"] > 0


@pytest.mark.parametrize("arch", worker.FLOP_ARCHS)
def test_one_device_counts_its_share_of_the_flops(meta_flops, arch):
    """One device's traced FLOPs: the whole count on one device, and on
    the (2, 2) mesh at least a quarter of it (more where a mesh dim
    leaves a product replicated) and at most all of it."""
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        (_, device), (whole, one) = meta_flops[f"{arch}:{shape_name}"]
        assert one == whole, shape_name
        for dtype, n in whole.items():
            assert n / 4 <= device[dtype] <= n, (shape_name, dtype)


@pytest.mark.parametrize("name,share", [("split", 4), ("replicated", 2)])
def test_one_device_counts_the_products_it_repeats(meta_flops, name,
                                                   share):
    """An (8, 16) by (16, 32) product, x split by rows over "data":
    split over both mesh dims (w's columns over "model") each device runs
    a quarter of its 8192 FLOPs; with w whole, the two devices of a model
    group each run the same half."""
    (sharded, device), (whole, one) = meta_flops[f"product:{name}"]
    assert sharded == whole == one == {"bfloat16": 2 * 8 * 16 * 32,
                                       "float32": 0.0}
    assert device == {"bfloat16": 2 * 8 * 16 * 32 / share, "float32": 0.0}


def test_dryrun_on_single_pod_over_the_fake_backend(tmp_path):
    """granite-3-2b ``decode_32k`` at full width on the 256-device mesh,
    traced in a process of its own: ok, finite per-device bytes that fit
    a card, collectives counted, the global traced FLOPs of the one-card
    record, and one device's share of them at least 1/256."""
    subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "granite-3-2b", "--shape", "decode_32k", "--mesh", "h100",
         "single_pod", "--out", str(tmp_path)],
        check=True, timeout=SPAWN_TIMEOUT, env=_src_env(),
        stdout=subprocess.DEVNULL)
    one, pod = (json.loads((tmp_path / f"granite-3-2b__decode_32k__{m}"
                            ".json").read_text())
                for m in ("h100", "single_pod"))
    assert one["status"] == pod["status"] == "ok", pod.get("error")
    assert pod["n_devices"] == 256 and pod["mesh"] == "single_pod"
    assert all(math.isfinite(v) for v in pod["bytes"].values())
    assert pod["bytes"]["total"] < one["bytes"]["total"]
    assert pod["fits_80gb"] and not one["fits_80gb"]
    assert pod["traced_flops_global"] == one["traced_flops_global"]
    roof = pod["roofline"]
    assert one["roofline"]["hlo_flops_per_device"] \
        == one["traced_flops_global"]
    assert one["traced_flops_global"] / 256 \
        <= roof["hlo_flops_per_device"] < one["traced_flops_global"]
    assert roof["collective_wire_bytes_per_device"] > 0
    assert roof["collective_s"] > 0
    assert pod["run"]["rules"]["embed"] is None     # inference's override
