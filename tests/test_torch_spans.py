"""The telemetry hub's wall-clock spans and where the port records them.

The recorder: ``perf_counter`` stamps whatever the hub's clock, the
thread's name, the ring's bound, spans from a second thread, a span
closed from an earlier start, ``spans.jsonl`` and the train and serve
launchers' ``--telemetry`` files.  The paths: a small CPU train run with
the async writer records the quorum hash's copy and digest once per
gradient leaf of each unit and the snapshot's write on the writer's
thread; a small engine run records one queue wait and one admission per
request and one step and one dispatch per decode step.
"""
from __future__ import annotations

import json
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch import tree as tu
from repro_torch.core import telemetry as tlm
from repro_torch.core.scheduler import SimClock


@pytest.fixture
def hub():
    """A fresh default hub for the test, the old one put back after."""
    tel = tlm.Telemetry()
    old = tlm.set_default(tel)
    yield tel
    tlm.set_default(old)


def _named(tel, name):
    return [s for s in tel.spans if s[0] == name]


def test_spans_take_the_wall_clock_whatever_the_hubs_clock():
    clock = SimClock()
    tel = tlm.Telemetry(clock=clock, tracing=True)
    before = time.perf_counter()
    with tel.span("work"):
        tel.event("submit", unit=1)
    after = time.perf_counter()
    (name, start, end, thread), = tel.spans
    assert name == "work" and thread == threading.current_thread().name
    assert before <= start <= end <= after
    assert tel.events[0]["t"] == clock()        # events keep the SimClock


def test_a_span_records_when_its_block_raises():
    tel = tlm.Telemetry()
    with pytest.raises(ValueError):
        with tel.span("fails"):
            raise ValueError("x")
    assert [s[0] for s in tel.spans] == ["fails"]


def test_add_span_closes_a_span_stamped_earlier():
    tel = tlm.Telemetry()
    start = time.perf_counter() - 0.5
    end = tel.add_span("queue", start)
    assert tel.spans[-1] == ("queue", start, end,
                             threading.current_thread().name)
    assert end - start >= 0.5


def test_the_span_ring_is_bounded_by_the_hubs_capacity():
    tel = tlm.Telemetry(capacity=8)
    for i in range(20):
        with tel.span(f"s{i}"):
            pass
    assert [s[0] for s in tel.spans] == [f"s{i}" for i in range(12, 20)]


def test_spans_from_another_thread_carry_its_name():
    tel = tlm.Telemetry()

    def work():
        for _ in range(100):
            with tel.span("bg"):
                pass
    t = threading.Thread(target=work, name="writer-like")
    t.start()
    for _ in range(100):
        with tel.span("fg"):
            pass
    t.join(timeout=30)
    assert not t.is_alive()
    threads = {(n, th) for n, _, _, th in tel.spans}
    assert threads == {("bg", "writer-like"),
                       ("fg", threading.current_thread().name)}
    assert len(tel.spans) == 200


def test_spans_jsonl_holds_one_sorted_span_a_line(tmp_path):
    tel = tlm.Telemetry()
    with tel.span("a"):
        pass
    tel.add_span("b", time.perf_counter())
    assert tel.dump_spans_jsonl(tmp_path / "spans.jsonl") == 2
    lines = (tmp_path / "spans.jsonl").read_text().splitlines()
    rows = [json.loads(x) for x in lines]
    assert [r["name"] for r in rows] == ["a", "b"]
    assert all(list(r) == sorted(r) == ["end", "name", "start", "thread"]
               for r in rows)
    assert all(r["start"] <= r["end"] for r in rows)


def test_the_launcher_writes_spans_jsonl(tmp_path):
    from repro_torch.launch import train
    old = tlm.get_default()
    try:
        train.main(["--device", "cpu", "--steps", "2", "--snapshot-every",
                    "1", "--telemetry", str(tmp_path)])
    finally:
        tlm.set_default(old)
    rows = [json.loads(x) for x in
            (tmp_path / "spans.jsonl").read_text().splitlines()]
    names = {r["name"] for r in rows}
    assert {"trainer.round", "trainer.unit", "trainer.hash.copy",
            "trainer.hash.digest", "trainer.update", "snapshot.plan",
            "snapshot.write"} <= names
    assert sum(r["name"] == "trainer.round" for r in rows) == 2


def test_the_serve_launcher_writes_the_engines_spans(tmp_path):
    from repro_torch.launch import serve
    old = tlm.get_default()
    try:
        out = serve.main(["--device", "cpu", "--arch", "granite-3-2b",
                          "--slots", "2", "--requests", "3",
                          "--prompt-len", "6", "--gen", "3",
                          "--telemetry", str(tmp_path)])
    finally:
        tlm.set_default(old)
    assert [len(t) for t in out["tokens"]] == [3, 3, 3]
    rows = [json.loads(x) for x in
            (tmp_path / "spans.jsonl").read_text().splitlines()]
    count = {n: sum(r["name"] == n for r in rows)
             for n in ("engine.queue", "engine.admit", "engine.step",
                       "engine.step.dispatch")}
    steps = out["decode_steps"]
    assert count == {"engine.queue": 3, "engine.admit": 3,
                     "engine.step": steps, "engine.step.dispatch": steps}
    assert "repro_serving_decode_steps" in \
        (tmp_path / "metrics.prom").read_text()


def test_the_serve_launchers_engine_refuses_what_it_cannot_serve():
    from repro_torch.launch import serve
    with pytest.raises(SystemExit):
        serve.main(["--device", "cpu", "--slots", "2", "--temperature",
                    "0.5"])


def _inside(spans, outer):
    _, s, e, th = outer
    return [x for x in spans if s <= x[1] and x[2] <= e and x[3] == th]


def test_a_train_run_records_the_hash_per_leaf_and_the_write_beside(hub):
    from repro_torch.launch import train
    args = train.parse_args(["--device", "cpu", "--snapshot-every", "2",
                             "--async-writer"])
    sess = train.build_trainer(train.build_arch(args.arch, args.preset),
                               args)
    tr = sess.trainer
    rounds = 4
    for step in range(rounds):
        tr.round(step)
    sess.snaps.close()
    leaves = len(tu.leaves(tr.state.params))
    main = threading.current_thread().name
    units = _named(hub, "trainer.unit")
    assert len(units) == rounds * args.micro
    copies = _named(hub, "trainer.hash.copy")
    digests = _named(hub, "trainer.hash.digest")
    assert len(copies) == len(digests) == len(units) * leaves
    for u in units:
        assert len(_inside(copies, u)) == len(_inside(digests, u)) == leaves
    assert len(_named(hub, "trainer.round")) == rounds
    assert len(_named(hub, "trainer.update")) == rounds
    plans = _named(hub, "snapshot.plan")
    writes = _named(hub, "snapshot.write")
    assert len(plans) == len(writes) == rounds // 2
    assert len(_named(hub, "snapshot.backpressure")) == rounds // 2
    assert {s[3] for s in plans} == {main}
    assert {s[3] for s in writes} == {"snapshot-writer"}
    assert {s[3] for s in copies + digests + units} == {main}
    # each write starts after its plan ends
    assert all(w[1] >= p[2] for p, w in zip(plans, writes))


def test_an_inline_snapshot_writes_on_the_callers_thread(hub):
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.snapshots import SnapshotManager
    mgr = SnapshotManager(ChunkStore())
    tree = {"w": torch.arange(64, dtype=torch.float32)}
    mgr.snapshot(tree, step=0)
    tree["w"][3] = -1.0
    info = mgr.snapshot(tree, step=1)
    assert not hasattr(info, "writer_ms")
    writes = _named(hub, "snapshot.write")
    assert len(writes) == 2
    assert {s[3] for s in writes} == {threading.current_thread().name}


def _engine(slots=2):
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    from repro_torch.serving.engine import ServingEngine
    cfg = reduced(get_arch("granite-3-2b"))
    gen = torch.Generator().manual_seed(0)
    params = init_tree(api.param_specs(cfg), gen, device="cpu")
    return cfg, ServingEngine(cfg, params, slots=slots, max_len=32)


def test_an_engine_run_records_queue_admit_step_and_dispatch(hub):
    from repro_torch.serving.engine import Request
    cfg, eng = _engine()
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=5 + i)
                    .astype(np.int32), 3 + i % 2) for i in range(5)]
    done = eng.run_queue(reqs)
    assert len(done) == 5
    queue, admit = _named(hub, "engine.queue"), _named(hub, "engine.admit")
    step = _named(hub, "engine.step")
    dispatch = _named(hub, "engine.step.dispatch")
    assert len(queue) == len(admit) == len(reqs)
    assert len(step) == len(dispatch) == eng.stats["decode_steps"]
    for s in step:
        assert len(_inside(dispatch, s)) == 1
    # each wait runs from the request's stamp to its admission's start
    for r, q, a in zip(reqs, queue, admit):
        assert q[1] == r.submitted and q[2] <= a[1]
    # the first slots' requests wait least; the fifth waits for a slot
    assert queue[4][2] - queue[4][1] > queue[0][2] - queue[0][1]


def test_run_queue_stamps_only_requests_without_a_hand_off(hub):
    from repro_torch.serving.engine import Request
    cfg, eng = _engine()
    prompt = np.arange(6, dtype=np.int32)
    mine = Request(0, prompt, 2, submitted=time.perf_counter() - 1.0)
    theirs = Request(1, prompt, 2)
    assert theirs.submitted is None
    before = time.perf_counter()
    eng.run_queue([mine, theirs])
    assert mine.submitted < before <= theirs.submitted
    assert mine.first_token_s >= 1.0 > theirs.first_token_s


def test_an_engine_on_the_cpu_decodes_eagerly(hub):
    """Off the card the decode step is never captured: every step runs
    eagerly, no replay is counted and no ``engine.step.replay`` span is
    recorded."""
    from repro_torch.serving.engine import Request, graphable
    cfg, eng = _engine()
    assert not graphable(eng.params, eng.caches)
    rng = np.random.default_rng(1)
    eng.run_queue([Request(i, rng.integers(0, cfg.vocab_size, size=4 + i)
                           .astype(np.int32), 4) for i in range(3)])
    assert eng.stats["decode_steps"] > 0
    assert eng.stats["decode_graph_replays"] == 0
    assert len(_named(hub, "engine.step.dispatch")) == \
        eng.stats["decode_steps"]
    assert not _named(hub, "engine.step.replay")
