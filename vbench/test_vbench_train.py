"""CPU tests of a training cell's ``correct``: whole runs at a small size
(``vbench.testing``), sound, with the timed path broken underneath
(``vbench.control.break_path``), with a snapshot that does not restore,
and under the float8 control."""
from __future__ import annotations

import pytest

from vbench import control, harness, testing
from vbench import run as vrun
from vbench.reference.precision import FP8
from vbench.testing import CPU, SECONDS, SEED, TRAIN, sound, tiny

threads = pytest.fixture(autouse=True, scope="module")(testing.one_thread)


@pytest.mark.parametrize("name,traffic", [
    ("granite-3-2b.train-snap", None),
    ("granite-3-2b.train-snap", "train-plain"),
])
def test_a_sound_run_meets_its_checks(name, traffic):
    cell = tiny(name, traffic)
    run = harness.Run(cell=cell, seed=SEED, seconds=SECONDS, trace=False)
    line = vrun.execute(run, CPU, False)
    sound(cell, line)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_a_traced_run_reads_its_host_metrics():
    name = "granite-3-2b.train-snap"
    cell = tiny(name)
    run = harness.Run(cell=cell, seed=SEED + 1, seconds=SECONDS, trace=True)
    line = vrun.execute(run, CPU, True)
    got = set(line["metrics"])
    # the device's metrics need the card's trace, and are left out here
    assert got and got <= {m["name"] for m in cell.per_layer}
    assert not any("roofline" in m or "idle" in m for m in got)
    sound(cell, line)


@pytest.mark.parametrize("traffic,fault", [
    (None, "unchanged"),
    (None, "half_batch"),
    ("train-plain", "half_batch"),
])
def test_a_broken_path_is_not_correct(traffic, fault):
    got = control.readings(tiny("granite-3-2b.train-snap", traffic), SEED,
                           SECONDS, CPU, fault=fault)
    assert not got["correct"], got


def test_a_snapshot_that_does_not_restore_is_not_correct(monkeypatch):
    from repro_torch.core.snapshots import SnapshotManager
    restore = SnapshotManager.restore

    def stale(self, *a, **kw):
        state, aux = restore(self, *a, **kw)
        key = sorted(state)[0]
        state[key] = state[key] + 1
        return state, aux
    monkeypatch.setattr(SnapshotManager, "restore", stale)
    got = control.readings(tiny("granite-3-2b.train-snap"), SEED, SECONDS,
                           CPU)
    assert got["checks"]["snapshot_leaves_differing"][0] >= 1
    assert not got["correct"]


def test_the_float8_control_reads_above_the_program():
    got = control.readings(tiny("granite-3-2b.train-snap", "train-plain"),
                           SEED, SECONDS, CPU, control=FP8)
    assert not got["control_correct"], got
    ctl = got["control_checks"]["grad_diff"]
    assert ctl[0] > ctl[1]
    assert got["checks"]["grad_diff"][0] <= ctl[1]
