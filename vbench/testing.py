"""What the CPU tests of whole runs share: the cells cut to a size a test
run holds, and what a sound run's checks must show.

The sizes are the cells' own configurations cut as their family's file
says (``TINY``: a width of 128 and two layers, or one period at tiny
widths), so a run takes seconds; the limits are the cells' own
(``workloads/<cell>.json``).  The harness's look for a card is skipped:
the tests call ``vbench.run.execute`` and ``vbench.control.readings``
with the CPU, where the port takes its kernels' plain versions."""
from __future__ import annotations

import sys

import torch

from vbench import harness
from vbench.reference import families

if str(harness.ROOT / "src") not in sys.path:   # the port, as the run has it
    sys.path.insert(0, str(harness.ROOT / "src"))

SEED = 2**31 + 4242
CPU = torch.device("cpu")
SECONDS = 0.5
TRAIN = ["granite-3-2b.train-snap"]
SERVE = ["hymba-1.5b.serve-chat"]


def tiny(name: str, traffic: str = None):
    """The cell, cut to a size a test run holds; with ``traffic``, under
    that mix of ``traffic/`` (as ``vbench.control --traffic`` reads it)."""
    cell = harness.load_cell(name)
    if traffic is not None:
        cell.traffic = harness.load_json(harness.HERE / "traffic"
                                         / f"{traffic}.json")
    return cut(cell)


def cut(cell):
    """``cell`` with its configuration cut to its family's ``TINY`` and
    its traffic to a few short requests or rows."""
    c = dict(cell.config, **families.of(cell.config).TINY)
    tr = dict(cell.traffic)
    if tr["driver"] == "train":
        tr.update(seq=32, batch=2)
    else:
        tr.update(slots=4, max_len=96, batch_requests=8,
                  prompt=dict(median=12, sigma=0.8, min=4, max=48),
                  output=dict(median=6, sigma=0.6, min=2, max=16),
                  check=dict(min_tokens=30, max_requests=4))
    cell.config, cell.traffic = c, tr
    return cell


def sound(cell, line: dict) -> None:
    """A sound run's checks: every limit compared, the exact ones met.  A
    serve cell's gaps sit far under their limits at this size; a train
    cell's gradient gaps are a worst leaf over leaves a few hundred
    elements long here, whose bf16 rounding can pass the limits set at
    the cell's own widths, so only their presence is held."""
    checks = line["checks"]
    want = set(cell.limits)
    if cell.driver == "serve":
        want.add("requests_failed")
    elif not cell.traffic["snapshot_every"]:
        want.discard("snapshot_leaves_differing")
    assert set(checks) == want
    assert all(c["value"] == c["value"] for c in checks.values())
    if cell.driver == "serve":
        assert line["correct"], checks
    elif "snapshot_leaves_differing" in checks:
        assert checks["snapshot_leaves_differing"]["value"] == 0


def one_thread():
    """Tiny products run fastest on one thread; the tests share the
    machine with other test processes.  A generator for a fixture."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(before)
