"""CPU tests of ``engine.decode_graph_share``: on synthetic spans put into
a fresh default telemetry hub, and on a whole traced serve run at a small
size (``vbench.testing``), where the CPU decodes eagerly and reads 0."""
from __future__ import annotations

import pytest

from vbench import harness, testing
from vbench import run as vrun
from vbench.testing import CPU, SECONDS, SEED, sound, tiny
from vbench.trace import DeviceTrace

METRIC = "engine.decode_graph_share"
MAIN = "MainThread"

threads = pytest.fixture(autouse=True, scope="module")(testing.one_thread)


@pytest.fixture
def hub():
    from repro_torch.core import telemetry as tlm
    tel = tlm.Telemetry()
    old = tlm.set_default(tel)
    yield tel
    tlm.set_default(old)


def put(tel, name, start, end, thread=MAIN):
    tel.spans.append((name, start, end, thread))


def a_run(window=(10.0, 20.0)):
    run = harness.Run(cell=harness.load_cell("hymba-1.5b.serve-chat"),
                      seed=1, seconds=1.0, trace=True)
    run.window = window
    return run


def read(run):
    return harness.metric_reader(METRIC)(run)


def test_the_share_returns_nothing_without_dispatch_spans(hub):
    run = a_run()
    run.tracer = DeviceTrace()
    run.traced = run.window
    put(hub, "engine.step.replay", 11.0, 11.1)   # a replay alone
    assert read(run) is None


def test_a_program_without_the_span_ring_gives_no_share(monkeypatch):
    from repro_torch.core import telemetry as tlm

    class Parent:                               # a hub that records none
        pass
    monkeypatch.setattr(tlm, "get_default", lambda: Parent())
    run = a_run()
    run.tracer = DeviceTrace()
    run.traced = run.window
    assert read(run) is None


def test_the_share_counts_the_dispatches_that_hold_a_replay(hub):
    run = a_run()
    for t in (11.0, 12.0, 13.0):
        put(hub, "engine.step.dispatch", t, t + 0.01)
        put(hub, "engine.step.replay", t + 0.002, t + 0.008)
    put(hub, "engine.step.replay", 25.0, 25.1)       # after the window
    assert read(run) == pytest.approx(100.0)
    put(hub, "engine.step.dispatch", 14.0, 14.2)     # an eager step
    assert read(run) == pytest.approx(75.0)


def test_a_traced_serve_run_on_the_cpu_reads_no_replays():
    cell = tiny("hymba-1.5b.serve-chat")
    run = harness.Run(cell=cell, seed=SEED + 3, seconds=SECONDS, trace=True)
    line = vrun.execute(run, CPU, True)
    assert line["metrics"][METRIC]["value"] == 0     # eager here
    sound(cell, line)
