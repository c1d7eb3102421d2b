"""Rank bodies for ``tests/test_torch_mesh.py``: each runs in one of the
processes ``torch.multiprocessing.spawn`` starts, joins a 4-rank gloo
group through a ``FileStore`` and builds a (2, 2) ("data", "model")
``DeviceMesh`` on the CPU.  A suite runs its checks one after another in
that one group (DTensor's sharding propagation is cached per process,
so later checks reuse what earlier ones worked out); each check's
outcome goes back to the test as "ok" or its traceback.  Every rank
runs every check, so a failed comparison fails on all of them alike.
Not a test module: pytest does not collect it, and it imports no JAX,
so a rank starts quickly."""
from __future__ import annotations

import dataclasses
import functools
import json
import os
import traceback

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import (DTensor, Replicate, Shard,
                                      distribute_tensor)

from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.configs.base import SHAPES, get_arch, reduced
from repro_torch.core import capsule
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.distributed.sharding import (ShardingRules, TensorSpec,
                                              constrain, init_tree,
                                              use_rules)
from repro_torch.launch import cell, flop_analysis, mesh
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw

WORLD = 4
TOL = 1e-5
# a bf16 cache leaf: one bf16 step, as tests/test_torch_launch.py holds
# bf16 KV caches (float32 values a few ulps apart may round apart)
CACHE_TOL = 2.0 ** -7


def small_shape(name: str, seq_len: int = 8, batch: int = 4):
    return dataclasses.replace(SHAPES[name], seq_len=seq_len,
                               global_batch=batch)


def whole(x) -> torch.Tensor:
    """A DTensor gathered whole (a collective: every rank calls it)."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def close(got, want, tol: float = TOL, what: str = "",
          scale: float = 0.0) -> None:
    """Within ``tol`` of the largest value compared (or of ``scale``, if
    larger), and ``tol`` relative."""
    got = whole(got).detach().double().numpy()
    want = whole(want).detach().double().numpy()
    assert got.shape == want.shape, (what, got.shape, want.shape)
    big = max(float(np.abs(want).max()) if want.size else 0.0, scale, 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol * big,
                               err_msg=what)


def close_trees(got, want, scale: float = 0.0) -> None:
    got_l, want_l = tu.flatten_with_keys(got), tu.flatten_with_keys(want)
    assert [k for k, _ in got_l] == [k for k, _ in want_l]
    for (key, g), (_, w) in zip(got_l, want_l):
        close(g, w, CACHE_TOL if w.dtype == torch.bfloat16 else TOL, key,
              scale)


def state_matches(got, want, before) -> None:
    """A train state updated from ``before``: the optimizer state within
    1e-5 of each leaf's largest value (the moments carry each leaf's
    gradient, linearly in m), and each param leaf's update (new - old)
    within 1e-5 of the leaf's largest update plus one ulp of the updated
    value, the rounding the stored param takes (a step-1 update is lr 3e-6
    after the warm-up: a 1.0 norm weight's ulp is 4 % of it, a 0.02 init
    weight's 0.06 %).  The update is held where the element's gradient is
    above 100 eps of AdamW's (73-87 % of the elements of the reduced
    families' trees): g / (sqrt(v) + eps) turns a gradient difference far
    below 1e-5 of its leaf into a far larger difference of that element's
    update where |g| is near eps (at 10 eps, up to 7.5 times the
    tolerance)."""
    close_trees(got.opt, want.opt)
    cfg = adamw.AdamWConfig()
    trees = (got.params, want.params, before.params, want.opt.m)
    for leaves in zip(*(tu.flatten_with_keys(t) for t in trees)):
        key = leaves[0][0]
        new, new_want, old, m = (whole(x).detach() for _, x in leaves)
        assert new_want.dtype == torch.float32, key
        step, want_step = (x.double().numpy() - old.double().numpy()
                           for x in (new, new_want))
        held = np.abs(m.double().numpy()) / (1 - cfg.beta1) > 100 * cfg.eps
        tol = TOL * max(float(np.abs(want_step).max()), 1e-30) \
            + np.spacing(np.abs(new_want.numpy()))
        bad = (np.abs(step - want_step) > tol) & held
        assert not bad.any(), (key, int(bad.sum()), bad.size)


def in_group(rank: int, store_file: str, body, *args) -> None:
    with mesh.process_group("gloo", WORLD, rank, store_file):
        body(mesh.make_mesh((2, 2), ("data", "model")), *args)


def run_step(c: cell.Cell):
    return c.step(*c.args)


def checks(rank: int, store_file: str, out: str, suite: str,
           *args) -> None:
    """Run ``suite``'s checks on the (2, 2) mesh; rank 0 writes each
    check's outcome ("ok" or the traceback) to ``out`` as JSON."""
    def body(m):
        results = {}
        for name, check in SUITES[suite](*args):
            try:
                check(m)
                results[name] = "ok"
            except Exception:      # recorded; the test for it fails
                results[name] = traceback.format_exc()
        if rank == 0:
            with open(out, "w") as f:
                json.dump(results, f)
    in_group(rank, store_file, body)


# ------------------------------------------------------------ the cells
FAMILIES = ("granite-3-2b", "deepseek-moe-16b", "falcon-mamba-7b",
            "seamless-m4t-medium")


def cells_match(m, arch_name: str, run) -> None:
    """The sharded train, prefill and decode cells of the reduced
    ``arch_name`` give the unsharded cells' loss, logits, updated state
    and caches."""
    arch = reduced(get_arch(arch_name))
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        shape = small_shape(shape_name)
        p = cell.build_cell(arch, shape, "cpu", run)
        plain = run_step(p)
        c = cell.build_cell(arch, shape, m, run)
        assert c.mesh is m and c.rules is not None
        sharded = run_step(c)
        if shape.kind == "train":
            for key in ("loss", "grad_norm"):
                close(sharded[1][key], plain[1][key], what=key)
            state_matches(sharded[0], plain[0], p.args[0])
        else:
            close(sharded[0], plain[0], what="logits")
            close_trees(sharded[1], plain[1])


def cell_suite():
    for fsdp in (False, True):
        run = RunConfig(compute_dtype=torch.float32, fsdp_gather_weights=fsdp)
        for arch in FAMILIES:
            yield f"{arch}:{fsdp}", functools.partial(cells_match,
                                                      arch_name=arch, run=run)


# ----------------------------------- the reference, capsules, snapshots
def place(tree, specs, rules):
    """A whole tree distributed to the placements ``rules`` give
    ``specs``."""
    return tu.unflatten_like(specs, {
        key: rules.distribute(x, spec) for (key, x), (_, spec) in
        zip(tu.flatten_with_keys(tree), tu.flatten_with_keys(specs))})


def reference_cells(m, ref_npz: str) -> None:
    """The reference's granite cells on its own (2, 2) mesh: the port's
    mesh cells from the same initial state give its train loss and its
    prefill logits."""
    z = np.load(ref_npz)
    state = convert.state_from_numpy(
        {k[len("state:"):]: z[k] for k in z.files if k.startswith("state:")},
        "cpu")
    arch = reduced(get_arch("granite-3-2b"))
    run = RunConfig(compute_dtype=torch.float32)
    shape = small_shape("train_4k", batch=int(z["logits"].shape[0]))
    c = cell.build_cell(arch, shape, m, run)
    args = (place(state, api.state_specs(arch), c.rules), c.args[1])
    _, metrics = c.step(*args)
    close(metrics["loss"], torch.as_tensor(z["loss"]), what="loss")
    c = cell.build_cell(arch, small_shape("prefill_32k", batch=shape.
                                          global_batch), m, run)
    params = place(state.params, api.param_specs(arch), c.rules)
    logits, _ = c.step(params, c.args[1])
    close(logits, torch.as_tensor(z["logits"]), what="logits")


def capsule_on_mesh(m, out_dir: str) -> None:
    """``boot(spec, mesh)``: the reference's mesh description, the same
    manifest hash as on a device, and a step on state placed by its rules
    equal to the unsharded capsule's step."""
    arch = reduced(get_arch("granite-3-2b"))
    spec = capsule.CapsuleSpec("granite-3-2b", "train_4k",
                               RunConfig(compute_dtype=torch.float32),
                               arch_override=arch)
    booted = capsule.boot(spec, m)
    plain = capsule.boot(spec, "cpu")
    assert booted.device_desc == "2x2:data,model", booted.device_desc
    assert booted.rules is not None and booted.rules.rules["embed"] == "data"
    specs = api.state_specs(arch)
    gen = torch.Generator().manual_seed(0)
    state = api.TrainState(init_tree(specs.params, gen, device="cpu"),
                           init_tree(specs.opt, gen, device="cpu"))
    batch = cell.concrete_batch(arch, small_shape("train_4k"))
    want_new, want_loss = plain.step(state, batch)
    new, loss = booted.step(place(state, specs, booted.rules),
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    close(loss, want_loss, what="loss")
    state_matches(new, want_new, state)
    if dist.get_rank() == 0:
        with open(os.path.join(out_dir, "capsule.json"), "w") as f:
            json.dump({"hash": spec.manifest_hash,
                       "desc": booted.device_desc}, f)


def snapshot_onto_mesh(m) -> None:
    """A snapshot taken unsharded, restored with rules: every leaf's
    shards put together are the whole leaf, bit for bit."""
    arch = reduced(get_arch("deepseek-moe-16b"))
    specs = api.state_specs(arch)
    gen = torch.Generator().manual_seed(1)
    state = api.TrainState(init_tree(specs.params, gen, device="cpu"),
                           init_tree(specs.opt, gen, device="cpu"))
    sm = SnapshotManager(ChunkStore(chunk_bytes=4096))
    sm.snapshot(state, step=3)
    rules = cell.cell_rules(m, small_shape("train_4k"), RunConfig())
    got, _ = sm.restore(target_tree=specs, rules=rules)
    want = dict(tu.flatten_with_keys(rules.tree_placements(specs),
                                     is_leaf=lambda x: isinstance(x, tuple)
                                     and not hasattr(x, "_fields")))
    pairs = list(zip(tu.flatten_with_keys(got), tu.flatten_with_keys(state)))
    assert len(pairs) == len(want)
    for (key, g), (_, w) in pairs:
        assert isinstance(g, DTensor), key
        assert tuple(g.placements) == want[key], key
        assert torch.equal(whole(g), w), key
    assert any(p.is_shard() for g in tu.leaves(got) for p in g.placements)


def fsdp_gather_is_counted(m) -> None:
    """One FSDP all-gather of a known weight: a (64, 16) float32 weight
    sharded over "data" (g = 2) gathered whole sends (g - 1) / g of its
    4096 output bytes."""
    rules = ShardingRules(m)
    spec = TensorSpec((64, 16), ("embed", None))
    w = rules.distribute(torch.ones(64, 16), spec)
    assert tuple(w.placements) == (Shard(0), Replicate())

    def gather(w):
        with use_rules(rules):
            return constrain(w, (None, None))
    _, _, stats = flop_analysis.traced(gather, w)
    assert stats.op_counts == {"all-gather": 1}, stats.op_counts
    assert stats.op_bytes == {"all-gather": 64 * 16 * 4}
    assert stats.wire_bytes_per_device == (2 - 1) / 2 * 64 * 16 * 4
    # both ranks of a data group sit in one 8-card node: NVLink's rate
    assert stats.seconds() == stats.wire_bytes_per_device / mesh.NVLINK_BW


def misc_suite(ref_npz: str, out_dir: str):
    yield "reference", functools.partial(reference_cells, ref_npz=ref_npz)
    yield "capsule", functools.partial(capsule_on_mesh, out_dir=out_dir)
    yield "snapshot", snapshot_onto_mesh
    yield "collectives", fsdp_gather_is_counted


# ------------------------------------------------- global FLOPs, on meta
FLOP_ARCHS = FAMILIES + ("qwen3-moe-30b-a3b", "hymba-1.5b")


def flops_on_meta(_: int, out: str) -> None:
    """In one process over the ``fake`` backend, a (2, 2) mesh of meta
    DTensors: each reduced family's train, prefill and decode cells, and
    the FLOPs ``flop_analysis.traced`` counts for each (global, and one
    device's) against the same cell on ``meta`` unsharded, and the same
    for one product split over both mesh dims and one left replicated
    over "model" -> {arch:shape or product:name: [sharded, unsharded]},
    each [global, one device's], in ``out``."""
    res = {}
    run = RunConfig()
    with mesh.process_group("fake", WORLD):
        m = mesh.make_mesh((2, 2), ("data", "model"))
        for arch_name in FLOP_ARCHS:
            arch = reduced(get_arch(arch_name))
            for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
                shape = small_shape(shape_name, seq_len=16, batch=8)
                got = [flop_analysis.traced(c.step, *c.args)[:2] for c in (
                    cell.build_cell(arch, shape, m, run),
                    cell.build_cell(arch, shape, "meta", run))]
                res[f"{arch_name}:{shape_name}"] = got
        x, w = torch.empty(8, 16, device="meta"), \
            torch.empty(16, 32, device="meta")
        for name, w_placements in (("split", (Replicate(), Shard(1))),
                                   ("replicated", (Replicate(),) * 2)):
            xd = distribute_tensor(x, m, (Shard(0), Replicate()))
            wd = distribute_tensor(w, m, w_placements)
            res[f"product:{name}"] = [
                flop_analysis.traced(torch.mm, xd, wd)[:2],
                flop_analysis.traced(torch.mm, x, w)[:2]]
    with open(out, "w") as f:
        json.dump(res, f)


SUITES = {"cells": cell_suite, "misc": misc_suite}
