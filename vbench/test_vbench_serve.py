"""CPU tests of a serving cell's ``correct``: whole runs at a small size
(``vbench.testing``), sound, with each served token altered where it is
produced (``vbench.control.break_path``), and under the float8
control."""
from __future__ import annotations

import pytest

from vbench import control, harness, testing
from vbench import run as vrun
from vbench.reference.precision import FP8
from vbench.testing import CPU, SECONDS, SEED, SERVE, sound, tiny

threads = pytest.fixture(autouse=True, scope="module")(testing.one_thread)


@pytest.mark.parametrize("name", SERVE)
def test_a_sound_run_meets_its_checks(name):
    cell = tiny(name)
    run = harness.Run(cell=cell, seed=SEED, seconds=SECONDS, trace=False)
    line = vrun.execute(run, CPU, False)
    sound(cell, line)
    assert list(line)[-1] == "checks"
    assert set(line["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert line["attempted"] > 0 and line["failed"] == 0


def test_a_traced_run_reads_its_host_metrics():
    name = "hymba-1.5b.serve-chat"
    cell = tiny(name)
    run = harness.Run(cell=cell, seed=SEED + 1, seconds=SECONDS, trace=True)
    line = vrun.execute(run, CPU, True)
    got = set(line["metrics"])
    assert got and got <= {m["name"] for m in cell.per_layer}
    assert not any("roofline" in m or "idle" in m for m in got)
    sound(cell, line)


@pytest.mark.parametrize("name", SERVE)
def test_an_altered_token_is_not_correct(name):
    got = control.readings(tiny(name), SEED, SECONDS, CPU, fault="token")
    assert not got["correct"], got


def test_the_float8_control_reads_above_the_program():
    # at this size the logits are too small for the control to exceed the
    # cell's limit, which it fails at the cell's own size (PERF.md); a
    # vocabulary of 8,192 puts near ties among the top logits, which the
    # control's rounding breaks; every served request is compared, so the
    # sample does not hang on how many batches the window ran
    cell = tiny("hymba-1.5b.serve-chat")
    cell.config = dict(cell.config, vocab_size=8192)
    cell.traffic = dict(cell.traffic,
                        check=dict(min_tokens=10**9, max_requests=10**9))
    got = control.readings(cell, SEED, SECONDS, CPU, control=FP8)
    prog, ctl = got["readings"]["program"], got["readings"]["control"]
    assert got["correct"] and any(ctl[k] > prog[k] for k in prog)
