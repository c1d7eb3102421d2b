"""CPU tests of whole traced runs at a small size (``vbench.testing``)
that read the program's own spans: the four training metrics and the two
serving metrics of ``program_span`` source read a number; the device's
operation count needs the card's trace and is left out."""
from __future__ import annotations

import pytest

from vbench import harness, testing
from vbench import run as vrun
from vbench.testing import CPU, SECONDS, SEED, sound, tiny

threads = pytest.fixture(autouse=True, scope="module")(testing.one_thread)
# The train window must hold a whole asynchronous write, so two snapshot
# periods: a tiny round takes ~70 ms alone and several times that on a
# host busy with other test workers, so 0.5 s can hold as few as two.
TRAIN_SECONDS = 6 * SECONDS


def test_a_traced_train_run_reads_the_programs_spans():
    cell = tiny("granite-3-2b.train-snap")
    run = harness.Run(cell=cell, seed=SEED + 2, seconds=TRAIN_SECONDS,
                      trace=True)
    line = vrun.execute(run, CPU, True)
    got = line["metrics"]
    for name in ("trainer.hash_copy_ms", "trainer.hash_digest_ms",
                 "snapshot.write_ms", "trainer.hash_write_overlap"):
        assert got[name]["value"] is not None, name
    assert got["trainer.hash_copy_ms"]["value"] > 0
    assert 0 <= got["trainer.hash_write_overlap"]["value"] <= 100
    sound(cell, line)


def test_a_traced_serve_run_reads_the_programs_spans():
    cell = tiny("hymba-1.5b.serve-chat")
    run = harness.Run(cell=cell, seed=SEED + 2, seconds=SECONDS, trace=True)
    line = vrun.execute(run, CPU, True)
    got = line["metrics"]
    for name in ("engine.queue_wait_p90_ms", "engine.decode_dispatch_ms"):
        assert got[name]["value"] > 0, name
    assert "engine.decode_ops" not in got
    # a batch of twice the slots: the p90 request waits for a slot
    assert got["engine.queue_wait_p90_ms"]["value"] > \
        got["engine.prefill_ms"]["value"]
    sound(cell, line)
