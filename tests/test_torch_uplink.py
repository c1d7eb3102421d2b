"""Port parity for the delta uplink and the project server.

The same f32 gradients, made with numpy from a seed, go through the JAX
package's ``grad_compress``/``core/uplink.py``/``core/server.py`` (on the
CPU its numpy ``ref`` diff) and through the port's on the CPU.  Everything
here is integer or bit-level, so the tolerance is none, bit for bit: the
quantized ``q`` and ``scale``, the store refs an encoder writes, the dense
bytes, the ``(moved, dedup)`` of a push, the decoded leaves, the quorum
hash of a folded unit, the tree diffs, the capsule manifest hash and the
DepDisk manifests.  The server's cases are ``tests/test_uplink.py``'s,
run on the port.
"""
from __future__ import annotations

import dataclasses
import json
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.core import capsule as j_capsule
from repro.core import depdisk as j_depdisk
from repro.core import elastic as j_elastic
from repro.core import server as j_server
from repro.core import uplink as j_uplink
from repro.core.chunkstore import ChunkStore as JChunkStore
from repro.core.scheduler import SimClock as JSimClock
from repro.core.scheduler import VolunteerScheduler as JScheduler
from repro.kernels.delta_encode import ops as j_ops
from repro.models.lm import RunConfig as JRunConfig
from repro.optim import grad_compress as j_gc
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import capsule, depdisk, elastic, server, uplink
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.scheduler import SimClock, VolunteerScheduler
from repro_torch.kernels.delta_encode import ops
from repro_torch.models.lm import RunConfig
from repro_torch.optim import grad_compress as gc

CB = 1 << 12               # small uplink chunks: a leaf spans many


def _t(tree):
    """The numpy tree as CPU tensors (nested dicts)."""
    return {k: _t(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def _j(tree):
    return {k: _j(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


# ---------------------------------------------------------------------------
# grad_compress: bit for bit
# ---------------------------------------------------------------------------
def _compress_case(name: str) -> np.ndarray:
    rng = np.random.default_rng(7)
    if name == "odd":
        return rng.standard_normal(1001).astype(np.float32)
    if name == "matrix":
        return (rng.standard_normal((37, 300)) * 1e3).astype(np.float32)
    if name == "zeros":
        return np.zeros(513, np.float32)
    if name == "extremes":           # largest finite magnitudes, no inf
        return np.array([3.4e38, -3.4e38, 1e-30, 5.0, -1.0] * 61,
                        np.float32)
    if name == "tiny_block":         # a block whose scale clamps at 1e-12
        x = rng.standard_normal(700).astype(np.float32)
        x[256:512] *= np.float32(1e-13)
        return x
    if name == "halves":             # exact .5 quotients: half to even
        return (np.arange(-300, 212, dtype=np.float32) / 2)
    raise ValueError(name)


@pytest.mark.parametrize("name", ["odd", "matrix", "zeros", "extremes",
                                  "tiny_block", "halves"])
def test_compress_equals_reference_bit_for_bit(name):
    g = {"x": _compress_case(name), "y": {"z": _compress_case("odd")[:77]}}
    jc, je = j_gc.compress(_j(g), j_gc.init_error(_j(g)))
    tc, te = gc.compress(_t(g), gc.init_error(_t(g)))
    for key in (("x",), ("y", "z")):
        a, b, ea, eb = jc, tc, je, te
        for k in key:
            a, b, ea, eb = a[k], b[k], ea[k], eb[k]
        assert isinstance(b, gc.Compressed)
        assert np.asarray(a.q).tobytes() == b.q.numpy().tobytes()
        assert np.asarray(a.scale).tobytes() == b.scale.numpy().tobytes()
        assert np.asarray(ea).tobytes() == eb.numpy().tobytes()
    jd, td = j_gc.decompress(jc, _j(g)), gc.decompress(tc, _t(g))
    assert np.asarray(jd["x"]).tobytes() == td["x"].numpy().tobytes()
    assert j_gc.wire_bytes(g) == gc.wire_bytes(_t(g))


def test_error_feedback_carries_the_reference_residual():
    """Three steps of error feedback: the carried residual, and so every
    later q and scale, stay bit-identical."""
    rng = np.random.default_rng(3)
    jerr, terr = None, None
    for _ in range(3):
        g = {"w": rng.standard_normal(3000).astype(np.float32)}
        jerr = j_gc.init_error(_j(g)) if jerr is None else jerr
        terr = gc.init_error(_t(g)) if terr is None else terr
        jc, jerr = j_gc.compress(_j(g), jerr)
        tc, terr = gc.compress(_t(g), terr)
        assert np.asarray(jc["w"].q).tobytes() == tc["w"].q.numpy().tobytes()
        assert np.asarray(jerr["w"]).tobytes() == terr["w"].numpy().tobytes()


# ---------------------------------------------------------------------------
# the encoder, push and decode
# ---------------------------------------------------------------------------
def _rounds() -> list:
    """Three rounds of f32 gradients: 'dense' changes everywhere, 'sparse'
    in one block, 'frozen' never, 'b.odd' (an odd size) in its tail."""
    rng = np.random.default_rng(11)
    r0 = {"dense": rng.standard_normal(20_000).astype(np.float32),
          "sparse": rng.standard_normal(50_000).astype(np.float32),
          "frozen": rng.standard_normal((30, 77)).astype(np.float32),
          "b": {"odd": rng.standard_normal(4_099).astype(np.float32)}}
    out = [r0]
    for i in range(1, 3):
        prev = out[-1]
        cur = {"dense": rng.standard_normal(20_000).astype(np.float32),
               "sparse": prev["sparse"].copy(),
               "frozen": prev["frozen"],
               "b": {"odd": prev["b"]["odd"].copy()}}
        cur["sparse"][1000 * i:1000 * i + 40] *= 3.0
        cur["b"]["odd"][-5:] += 1.0
        out.append(cur)
    return out


def _encode_both(rounds):
    jenc = j_uplink.UplinkEncoder(chunk_bytes=CB, mode="ref")
    tenc = uplink.UplinkEncoder(chunk_bytes=CB)
    pairs = []
    for g in rounds:
        jc, _ = j_gc.compress(_j(g), j_gc.init_error(_j(g)))
        tc, _ = gc.compress(_t(g), gc.init_error(_t(g)))
        pairs.append((jenc.encode(jc), tenc.encode(tc), jc, tc))
    return pairs, jenc, tenc


def test_encoder_writes_the_reference_refs_over_three_rounds():
    pairs, jenc, tenc = _encode_both(_rounds())
    for i, (ju, tu_, _, _) in enumerate(pairs):
        assert tu_.refs == ju.refs, f"round {i}"
        assert tu_.dense_bytes == ju.dense_bytes
        assert {k: dataclasses.asdict(m) for k, m in tu_.meta.items()} == \
            {k: dataclasses.asdict(m) for k, m in ju.meta.items()}
        assert all(m.dtype == "int8" for m in tu_.meta.values())
    # rounds 1 and 2: every leaf diffed (4 leaves), 'frozen' kept its refs
    assert (tenc.units, tenc.diffs) == (3, 8)
    assert pairs[2][1].refs["['frozen']"] == pairs[0][1].refs["['frozen']"]
    assert jenc.gc() == tenc.gc()


def test_push_and_decode_match_the_reference():
    pairs, _, _ = _encode_both(_rounds())
    jserver, tserver = JChunkStore(chunk_bytes=CB), ChunkStore(chunk_bytes=CB)
    for ju, tu_, jc, tc in pairs:
        assert uplink.push_update(tu_, tserver, client_id="v") == \
            j_uplink.push_update(ju, jserver, client_id="v")
        jd = j_uplink.decode_update(jserver, ju)
        td = uplink.decode_update(tserver, tu_)
        assert jd.keys() == td.keys()
        for key in jd:
            assert td[key].q.device.type == "cpu"
            assert np.asarray(jd[key].q).tobytes() == \
                td[key].q.numpy().tobytes()
            assert np.asarray(jd[key].scale).tobytes() == \
                td[key].scale.numpy().tobytes()
            want = j_uplink.leaf_image(j_uplink.flatten_compressed(jc)[key])
            assert uplink.leaf_image(td[key]).numpy().tobytes() == \
                want.tobytes()
    assert dict(tserver.uplinks["v"]) == dict(jserver.uplinks["v"])


def test_decode_update_rebuilds_on_the_named_device():
    g = {"w": np.ones(3000, np.float32)}
    tc, _ = gc.compress(_t(g), gc.init_error(_t(g)))
    store = ChunkStore(chunk_bytes=CB)
    upd = uplink.UplinkEncoder(chunk_bytes=CB).encode(tc)
    uplink.push_update(upd, store, client_id="v")
    dec = uplink.decode_update(store, upd, device="meta")
    assert dec["['w']"].q.device.type == "meta"
    assert dec["['w']"].q.dtype == torch.int8


# ---------------------------------------------------------------------------
# the one-shot tree diff
# ---------------------------------------------------------------------------
def _tree_pair():
    rng = np.random.default_rng(0)
    old = {"a": rng.standard_normal(3000).astype(np.float32),
           "b": {"c": rng.standard_normal((300, 1100)).astype(np.float32),
                 "d": rng.integers(0, 100, 77).astype(np.int8)},
           "e": rng.standard_normal(360_000).astype(np.float32),
           "g": rng.standard_normal(5).astype(np.float16)}
    new = {"a": old["a"].copy(),
           "b": {"c": old["b"]["c"].copy(), "d": old["b"]["d"].copy()},
           "e": old["e"].copy(), "g": old["g"].copy()}
    new["a"][5] += 1
    new["b"]["c"][200, 3] = 7
    new["b"]["d"][3] = 1
    new["e"][-1] = 0.5
    return old, new


@pytest.mark.parametrize("bucketed,max_tiles", [(True, 8), (True, 256),
                                                (False, 256)])
def test_tree_changed_blocks_equals_reference(bucketed, max_tiles):
    old, new = _tree_pair()
    want = j_ops.tree_changed_blocks(old, new, mode="ref", bucketed=bucketed,
                                     max_bucket_tiles=max_tiles)
    got = ops.tree_changed_blocks(_t(old), _t(new), bucketed=bucketed,
                                  max_bucket_tiles=max_tiles)
    assert got.keys() == want.keys()
    for key, (tiles, bitmap, nbytes) in want.items():
        assert np.array_equal(got[key][0], tiles), key
        assert np.array_equal(got[key][1], bitmap), key
        assert got[key][2] == nbytes


def test_diff_leaves_with_a_mirror_diffs_against_the_last_round():
    """With a ``DeviceMirror`` the second call diffs against the first
    call's new leaves (held in the slots), as the reference's kernel
    route does."""
    old, new = _tree_pair()
    mirror = ops.DeviceMirror()
    ops.tree_changed_blocks(_t(old), _t(new), mirror=mirror)
    assert len(mirror)
    newer = _t(new)
    newer["a"][0] = 9.0
    # ``old`` is stale on purpose: where a slot matches it is not read
    got = ops.tree_changed_blocks(_t(old), newer, mirror=mirror)
    for key, leaf in (("['a']", "a"), ("['e']", "e")):
        want = j_ops.changed_blocks(new[leaf], newer[leaf].numpy(),
                                    mode="ref")
        assert np.array_equal(got[key][1], want[1]), key
        assert np.array_equal(got[key][0], want[0]), key
    assert got["['a']"][1].sum() == 1 and got["['e']"][1].sum() == 0


def test_empty_leaf_keeps_its_bucket_neighbours_aligned():
    """The port counts an empty leaf as 0 tiles, as ``probe_leaves`` does,
    so a changed 1-tile leaf after it in the same size bucket still shows
    its change.  (The reference's ``diff_leaves`` counts it as 1 tile and
    reads its neighbour's bitmap one tile off: ROADMAP Queue 3.)"""
    old = {"e": np.zeros(0, np.float32), "f": np.zeros(0, np.float32),
           "g": np.ones(5, np.float16)}
    new = {"e": old["e"], "f": old["f"], "g": old["g"].copy()}
    new["g"][0] = 2
    got = ops.tree_changed_blocks(_t(old), _t(new))
    assert got["['g']"][1].tolist() == [1]
    assert got["['e']"][1].size == 0 and got["['f']"][1].size == 0
    single = ops.changed_blocks(torch.from_numpy(old["g"]),
                                torch.from_numpy(new["g"]))
    assert np.array_equal(got["['g']"][0], single[0])
    ref = j_ops.tree_changed_blocks(old, new, mode="ref")
    assert ref["['g']"][1].tolist() != [1]          # the reference's miss


# ---------------------------------------------------------------------------
# the project server (tests/test_uplink.py's cases, on the port)
# ---------------------------------------------------------------------------
def _server_with_project(quorum=2, replication=None):
    sched = VolunteerScheduler(replication=replication or quorum,
                               quorum=quorum, clock=SimClock())
    srv = server.VBoincServer(ChunkStore(chunk_bytes=CB))
    spec = capsule.CapsuleSpec("qwen2-1.5b", "train_4k", RunConfig())
    srv.publish(server.Project("toy", spec, scheduler=sched))
    return srv, sched


def _comp(g):
    return gc.compress(_t(g), gc.init_error(_t(g)))[0]


def test_server_quorum_folds_canonical_update():
    srv, sched = _server_with_project(quorum=2)
    g = {"w": np.random.default_rng(5).standard_normal(60_000)
         .astype(np.float32)}
    comp = _comp(g)
    img = uplink.leaf_image(comp["w"]).numpy().tobytes()
    sched.join("a")
    sched.join("b")
    sched.submit(0, {})
    sched.request_work("a")
    sched.request_work("b")
    for wid in ("a", "b"):
        upd = uplink.UplinkEncoder(chunk_bytes=CB).encode(comp)
        assert srv.report_result("toy", wid, 0, "H",
                                 update=upd) == (wid == "b")
    assert 0 in srv.projects["toy"].canonical_updates
    dec = srv.resolve_round_update("toy", 0)
    assert uplink.leaf_image(dec["['w']"]).numpy().tobytes() == img
    log = srv.uplinks["toy"]
    assert log.accepted == 2 and log.rejected == 0
    assert srv.store.uplinks["b"]["bytes_dedup"] > 0
    assert (srv.store.uplinks["b"]["bytes_in"]
            < srv.store.uplinks["a"]["bytes_in"] / 10)


def test_decode_failure_claws_back_credit():
    srv, sched = _server_with_project(quorum=1)
    upd = uplink.UplinkEncoder(chunk_bytes=CB).encode(
        _comp({"w": np.ones(30_000, np.float32)}))
    upd.meta[next(iter(upd.meta))].blocks += 1     # records valid, meta lies
    sched.join("liar")
    sched.submit(0, {})
    sched.request_work("liar")
    assert not srv.report_result("toy", "liar", 0, "H", update=upd)
    assert not sched.units[0].completed
    assert srv.uplinks["toy"].rejected == 1
    log = srv.store.uplinks["liar"]
    assert log["bytes_in"] == 0 and log["bytes_dedup"] == 0
    assert log["rejected"] == 1


@pytest.mark.parametrize("fault", ["tampered", "dangling"])
def test_server_rejects_bad_update_before_scheduler(fault):
    srv, sched = _server_with_project(quorum=1)
    enc = uplink.UplinkEncoder(chunk_bytes=CB)
    g = {"w": np.random.default_rng(2).standard_normal(30_000)
         .astype(np.float32)}
    upd = enc.encode(_comp(g))
    if fault == "tampered":
        # flip one bit inside the client store: export ships a record
        # whose hash no longer matches its ref
        h = next(iter(upd.store._mem))
        upd.store._mem[h] = upd.store._mem[h][:-1] + bytes(
            [upd.store._mem[h][-1] ^ 1])
    else:
        # a delta round whose parent the server never received
        g["w"][:40] *= 2.0
        upd = enc.encode(_comp(g))
        assert any(r.startswith("d:") for r in upd.all_refs())
        parents = [r for r in upd.store.live_closure(upd.all_refs())
                   if not r.startswith("d:")]
        for r in parents:
            upd.store._mem.pop(r)
    sched.join("liar")
    sched.submit(0, {})
    sched.request_work("liar")
    assert not srv.report_result("toy", "liar", 0, "H", update=upd)
    assert not sched.units[0].completed            # scheduler never saw it
    assert srv.uplinks["toy"].rejected == 1
    assert srv.store.uplinks.get("liar", {}).get("bytes_in", 0) == 0


class _ToyState(NamedTuple):
    params: dict


class _ToyStream:
    def batch(self, i):
        return {"i": np.int64(i)}


def _toy_grad(i: int, n: int) -> np.ndarray:
    g = np.zeros(n, np.float32)
    g[(i * 3) % 8] = 1.0 + (i % 4) * 0.25          # sparse + deterministic
    return g


def _port_toy_trainer(srv, micro=2, **kw):
    def grad_fn(params, batch):
        i = int(batch["i"])
        return float(i), {"w": torch.from_numpy(
            _toy_grad(i, params["w"].numel()))}

    def apply_fn(state, grads):
        return _ToyState({"w": state.params["w"] - 0.1 * grads["w"]})

    return elastic.VolunteerTrainer(
        grad_fn=grad_fn, apply_fn=apply_fn,
        state=_ToyState({"w": torch.zeros(150_000)}), stream=_ToyStream(),
        micro_batches=micro, server=srv, project="toy", uplink=True,
        uplink_chunk_bytes=CB, **kw)


def _jax_toy_trainer(quorum=1, micro=2):
    sched = JScheduler(replication=quorum, quorum=quorum, clock=JSimClock())
    srv = j_server.VBoincServer(JChunkStore(chunk_bytes=CB))
    spec = j_capsule.CapsuleSpec("qwen2-1.5b", "train_4k", JRunConfig())
    srv.publish(j_server.Project("toy", spec, scheduler=sched))

    def grad_fn(params, batch):
        i = int(batch["i"])
        return float(i), {"w": _toy_grad(i, params["w"].size)}

    def apply_fn(state, grads):
        return _ToyState({"w": state.params["w"]
                          - 0.1 * np.asarray(grads["w"])})

    tr = j_elastic.VolunteerTrainer(
        grad_fn=grad_fn, apply_fn=apply_fn,
        state=_ToyState({"w": np.zeros(150_000, np.float32)}),
        stream=_ToyStream(), micro_batches=micro, server=srv,
        project="toy", uplink=True, uplink_chunk_bytes=CB,
        uplink_mode="ref")
    return tr, srv, sched


def test_trainer_uplink_rounds_match_the_reference():
    """Three rounds on two volunteers: the same round stats, per-worker
    credit and canonical hashes as the JAX trainer, and the server's fold
    of the last unit dequantizes to the gradient the quorum validated."""
    srv, sched = _server_with_project(quorum=1)
    tr = _port_toy_trainer(srv)
    assert tr.sched is sched                       # one unit table
    jtr, _, jsched = _jax_toy_trainer()
    for t in (tr, jtr):
        for wid in ("v0", "v1"):
            t.add_worker((elastic.SimWorker if t is tr
                          else j_elastic.SimWorker)(wid))
    hist, jhist = tr.run(3), jtr.run(3)
    assert [dataclasses.asdict(h) for h in hist] == \
        [dataclasses.asdict(h) for h in jhist]
    assert hist[0].uplink_moved > 0
    for h in hist[1:]:
        assert 0 < h.uplink_moved < h.uplink_dense
    for wid in ("v0", "v1"):
        a, b = sched.workers[wid], jsched.workers[wid]
        assert (a.credit, a.uplink_bytes, a.completed) == \
            (b.credit, b.uplink_bytes, b.completed)
        assert a.credit > a.completed              # transfer credit on top
    assert {u: sched.units[u].canonical for u in range(6)} == \
        {u: jsched.units[u].canonical for u in range(6)}
    proj = srv.projects["toy"]
    assert sorted(proj.canonical_updates) == list(range(6))
    dec = srv.resolve_round_update("toy", 5)
    arr = gc.decompress_leaf(dec["['w']"], (150_000,), torch.float32)
    assert elastic.grad_hash({"w": arr}) == sched.units[5].canonical


def test_uplink_credit_waits_for_quorum():
    """A worker whose result fails validation earns no transfer credit
    even though its (valid-looking) bytes were ingested."""
    srv, sched = _server_with_project(quorum=2, replication=3)
    tr = _port_toy_trainer(srv, micro=1)
    liar = elastic.SimWorker("liar", corrupt_prob=1.0)
    honest = [elastic.SimWorker("h0"), elastic.SimWorker("h1")]
    for w in [liar] + honest:
        tr.add_worker(w)
    sched.submit(0, {})
    unit = type("U", (), {"unit_id": 0})()
    g = {"w": torch.from_numpy(_toy_grad(0, 150_000))}
    for w in [liar] + honest:
        sched.request_work(w.worker_id)
        tr._execute_unit_uplink(w, unit, 0.0, g)
    tr._settle_uplink_credit(sched.drain_completed())
    assert sched.workers["liar"].credit == 0.0
    assert sched.workers["liar"].uplink_bytes == 0
    assert sched.workers["h0"].credit > 0 or sched.workers["h1"].credit > 0


def test_uplink_needs_a_server_and_the_projects_scheduler():
    with pytest.raises(ValueError, match="server"):
        elastic.VolunteerTrainer(grad_fn=None, apply_fn=None, state=None,
                                 stream=None, micro_batches=1, uplink=True)
    srv, _ = _server_with_project()
    with pytest.raises(ValueError, match="project's"):
        elastic.VolunteerTrainer(
            grad_fn=None, apply_fn=None, state=None, stream=None,
            micro_batches=1, server=srv, project="toy",
            scheduler=VolunteerScheduler(clock=SimClock()))


# ---------------------------------------------------------------------------
# capsules and DepDisks
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch,kw,override", [
    ("granite-3-2b", {}, False),
    ("granite-3-2b", {"remat": "none", "block_kv": 64, "ssm_chunk": 64},
     True),
    ("qwen2-1.5b", {"compute_dtype": "float32"}, False),
    ("deepseek-moe-16b", {"capacity_factor": 2.0, "remat": "none"}, True),
    ("seamless-m4t-medium", {}, False),
    ("seamless-m4t-medium", {"remat": "none", "block_kv": 256}, True),
])
def test_capsule_manifest_hash_equals_reference(arch, kw, override):
    jkw, tkw = dict(kw), dict(kw)
    if "compute_dtype" in kw:
        jkw["compute_dtype"] = getattr(jnp, kw["compute_dtype"])
        tkw["compute_dtype"] = getattr(torch, kw["compute_dtype"])
    jspec = j_capsule.CapsuleSpec(
        arch, "train_4k", JRunConfig(**jkw),
        arch_override=j_reduced(j_get_arch(arch)) if override else None)
    spec = capsule.CapsuleSpec(
        arch, "train_4k", RunConfig(**tkw),
        arch_override=reduced(get_arch(arch)) if override else None)
    assert spec.manifest() == jspec.manifest()
    assert spec.manifest_hash == jspec.manifest_hash
    # publish stores the manifest as one chunk under the same ref
    js, ts = JChunkStore(), ChunkStore()
    j_server.VBoincServer(js).publish(j_server.Project("p", jspec))
    server.VBoincServer(ts).publish(server.Project("p", spec))
    assert ts.has(jspec.manifest_hash) and js.has(spec.manifest_hash)


def test_boot_refuses_a_tampered_hash_and_steps_on_the_cpu():
    cfg = reduced(get_arch("granite-3-2b"))
    spec = capsule.CapsuleSpec("granite-3-2b", "train_4k",
                               RunConfig(remat="none", block_kv=16),
                               arch_override=cfg)
    other = capsule.CapsuleSpec("granite-3-2b", "train_4k",
                                RunConfig(remat="full", block_kv=16),
                                arch_override=cfg)
    with pytest.raises(PermissionError):
        capsule.boot(spec, "cpu", verify_hash=other.manifest_hash)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            capsule.boot(spec, "cuda")
    booted = capsule.boot(spec, "cpu", verify_hash=spec.manifest_hash)
    assert booted.device_desc == "cpu" and booted.boot_wall_s >= 0
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    specs = api.state_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    state = api.TrainState(init_tree(specs.params, gen, device="cpu"),
                           init_tree(specs.opt, gen, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 17), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    new, loss = booted.step(state, batch)
    assert torch.isfinite(loss) and int(new.opt.step) == 1


def _disk_manifests(ds) -> dict:
    out = {}
    for name, mgr in ds._managers.items():
        mans = []
        for sid in mgr.order:
            m = json.loads(mgr.manifests[sid].to_json())
            m.pop("created")
            mans.append(m)
        out[name] = mans
    return out


def test_depdisk_manifests_equal_reference():
    """Base disk + two DepDisks, a diff snapshot, a swap and a GC: the
    same manifests (all but the clock) and the same disk table."""
    rng = np.random.default_rng(4)
    params = {"w": rng.standard_normal((64, 300)).astype(np.float32),
              "b": rng.standard_normal(300).astype(np.float32)}
    opt = {"m": np.zeros((64, 300), np.float32),
           "v": rng.standard_normal(999).astype(np.float32)}
    lora = {"a": rng.standard_normal((8, 64)).astype(np.float32)}
    sets = (j_depdisk.DiskSet(JChunkStore(chunk_bytes=CB)),
            depdisk.DiskSet(ChunkStore(chunk_bytes=CB)))
    for ds, conv in zip(sets, (lambda t: t, _t)):
        ds.create_base(conv(params), step=0)
        ds.attach_dep("adamw", conv(opt), step=0)
        opt2 = {"m": opt["m"] + 1, "v": opt["v"]}
        ds.snapshot_disk("adamw", conv(opt2), step=1)
        ds.swap_task("adamw", "lora", conv(lora))
        ds.gc_all()
    jd, td = sets
    assert _disk_manifests(td) == _disk_manifests(jd)
    assert [dataclasses.asdict(d) for d in td.disks()] == \
        [dataclasses.asdict(d) for d in jd.disks()]
    got, _ = td.restore_disk("adamw", target_tree=_t(opt))
    assert np.array_equal(got["m"].numpy(), opt["m"] + 1)


# ---------------------------------------------------------------------------
# the edge route of restore_latest
# ---------------------------------------------------------------------------
def test_restore_through_the_edge_matches_the_reference():
    """A snapshot of the same state through each package's trainer, then
    ``restore_latest(client_hashes=set())`` through a one-cache edge tier:
    the same plan, the route names the cache, and the bytes come back."""
    from repro.core import edge as j_edge
    from repro.core.snapshots import SnapshotManager as JSnapshotManager
    from repro_torch.core import edge
    from repro_torch.core.snapshots import SnapshotManager
    rng = np.random.default_rng(8)
    w = rng.standard_normal(40_000).astype(np.float32)
    plans = []
    for pkg in ("jax", "torch"):
        if pkg == "jax":
            store = JChunkStore(chunk_bytes=CB)
            tier = j_edge.EdgeTier(store, [j_edge.EdgeCache("edge-0")])
            snaps = JSnapshotManager(store, keep_last=3)
            tr = j_elastic.VolunteerTrainer(
                grad_fn=None, apply_fn=None, state=_ToyState({"w": w}),
                stream=None, micro_batches=1, snapshots=snaps, edge=tier)
            snaps.snapshot(tr.state, step=0,
                           aux={"cursor": {"next_index": 2}, "round": 0})
            nxt = tr.restore_latest(_ToyState({"w": w}), client_hashes=set())
            back = np.asarray(tr.state.params["w"])
        else:
            store = ChunkStore(chunk_bytes=CB)
            tier = edge.EdgeTier(store, [edge.EdgeCache("edge-0")])
            snaps = SnapshotManager(store, keep_last=3)
            tr = elastic.VolunteerTrainer(
                grad_fn=None, apply_fn=None,
                state=_ToyState({"w": torch.from_numpy(w.copy())}),
                stream=None, micro_batches=1, snapshots=snaps, edge=tier)
            snaps.snapshot(tr.state, step=0,
                           aux={"cursor": {"next_index": 2}, "round": 0})
            nxt = tr.restore_latest(_ToyState({"w": torch.zeros(1)}),
                                    client_hashes=set())
            back = tr.state.params["w"].numpy()
        assert nxt == 1 and np.array_equal(back, w)
        plans.append((tr.last_restore_plan, dict(tier.stats)))
    assert plans[0] == plans[1]
    assert plans[1][0]["route"] == "edge-0"
