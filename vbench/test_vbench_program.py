"""CPU tests of the readers of the program's own spans
(``vbench/program.py`` and the metrics that read it) on synthetic spans
put into a fresh default telemetry hub, and of ``engine.decode_ops`` on a
synthetic device trace."""
from __future__ import annotations

import pytest

from vbench import harness, testing  # noqa: F401  (puts the port on the path)
from vbench.trace import DeviceTrace

MAIN, WRITER = "MainThread", "snapshot-writer"
READERS = ["trainer.hash_copy_ms", "trainer.hash_digest_ms",
           "snapshot.write_ms", "trainer.hash_write_overlap",
           "engine.queue_wait_p90_ms", "engine.decode_dispatch_ms",
           "engine.decode_ops"]


@pytest.fixture
def hub():
    from repro_torch.core import telemetry as tlm
    tel = tlm.Telemetry()
    old = tlm.set_default(tel)
    yield tel
    tlm.set_default(old)


def put(tel, name, start, end, thread=MAIN):
    tel.spans.append((name, start, end, thread))


def a_run(name, window=(10.0, 20.0)):
    run = harness.Run(cell=harness.load_cell(name), seed=1, seconds=1.0,
                      trace=True)
    run.window = window
    return run


def read(metric, run):
    return harness.metric_reader(metric)(run)


@pytest.mark.parametrize("metric", READERS)
def test_a_reader_returns_nothing_without_its_spans(hub, metric):
    run = a_run("hymba-1.5b.serve-chat")
    run.tracer = DeviceTrace()
    run.traced = run.window
    put(hub, "trainer.round", 11.0, 12.0)       # another name only
    assert read(metric, run) is None


@pytest.mark.parametrize("metric", READERS)
def test_a_program_without_the_span_ring_gives_nothing(monkeypatch, metric):
    from repro_torch.core import telemetry as tlm

    class Parent:                               # a hub that records none
        pass
    monkeypatch.setattr(tlm, "get_default", lambda: Parent())
    run = a_run("granite-3-2b.train-snap")
    run.tracer = DeviceTrace()
    run.traced = run.window
    assert read(metric, run) is None


def test_hash_copy_and_digest_per_unit(hub):
    run = a_run("granite-3-2b.train-snap")
    put(hub, "trainer.unit", 5.0, 9.0)           # before the window
    put(hub, "trainer.hash.copy", 6.0, 7.0)
    for u in (11.0, 14.0):
        put(hub, "trainer.unit", u, u + 2.0)
        put(hub, "trainer.hash.copy", u + 0.5, u + 0.6)
        put(hub, "trainer.hash.copy", u + 0.7, u + 0.9)
        put(hub, "trainer.hash.digest", u + 0.6, u + 0.7)
        put(hub, "trainer.hash.digest", u + 0.9, u + 1.5)
    assert read("trainer.hash_copy_ms", run) == pytest.approx(300.0)
    assert read("trainer.hash_digest_ms", run) == pytest.approx(700.0)


def test_snapshot_write_is_the_mean_of_the_writes_inside_the_window(hub):
    run = a_run("granite-3-2b.train-snap")
    put(hub, "snapshot.write", 9.0, 12.0, WRITER)    # straddles the start
    put(hub, "snapshot.write", 13.0, 14.0, WRITER)
    put(hub, "snapshot.write", 15.0, 18.0, WRITER)
    put(hub, "snapshot.write", 19.0, 21.0, WRITER)   # straddles the end
    assert read("snapshot.write_ms", run) == pytest.approx(2000.0)


def test_hash_write_overlap_counts_writes_on_another_thread(hub):
    run = a_run("granite-3-2b.train-snap")
    put(hub, "trainer.hash.copy", 11.0, 12.0)
    put(hub, "trainer.hash.digest", 12.0, 14.0)
    put(hub, "trainer.hash.digest", 16.0, 17.0)
    # a write from before the window covers the first second of hashing
    put(hub, "snapshot.write", 9.0, 12.0, WRITER)
    put(hub, "snapshot.write", 13.5, 14.5, WRITER)
    put(hub, "snapshot.write", 16.0, 17.0, MAIN)     # inline: same thread
    assert read("trainer.hash_write_overlap", run) == pytest.approx(
        100.0 * (1.0 + 0.5) / 4.0)


def test_queue_wait_is_the_90th_percentile_of_the_window(hub):
    from vbench import stats
    run = a_run("hymba-1.5b.serve-chat")
    waits = [0.1 * k for k in range(1, 11)]
    for w in waits:
        put(hub, "engine.queue", 15.0 - w, 15.0)
    put(hub, "engine.queue", 1.0, 15.0)              # handed before
    assert read("engine.queue_wait_p90_ms", run) == pytest.approx(
        stats.percentile(waits, 90) * 1e3)


def test_decode_dispatch_is_the_mean_call(hub):
    run = a_run("hymba-1.5b.serve-chat")
    put(hub, "engine.step.dispatch", 11.0, 11.01)
    put(hub, "engine.step.dispatch", 12.0, 12.03)
    put(hub, "engine.step.dispatch", 25.0, 25.5)     # after the window
    assert read("engine.decode_dispatch_ms", run) == pytest.approx(20.0)


def test_decode_ops_counts_the_operations_inside_whole_traced_steps(hub):
    run = a_run("hymba-1.5b.serve-chat")
    run.traced = (10.0, 16.0)
    put(hub, "engine.step", 11.0, 12.0)
    put(hub, "engine.step", 13.0, 14.0)
    put(hub, "engine.step", 15.5, 16.5)              # past the trace's end
    t = DeviceTrace()
    t.events = [("prefill", 10.5, 10.9),             # outside any step
                ("a", 11.1, 11.2), ("b", 11.3, 11.4), ("c", 11.9, 12.1),
                ("a", 13.2, 13.3),
                ("between", 14.2, 14.3),
                ("late", 15.6, 15.7)]
    assert read("engine.decode_ops", run) is None    # no trace: nothing
    run.tracer = t
    assert read("engine.decode_ops", run) == pytest.approx((3 + 1) / 2)
