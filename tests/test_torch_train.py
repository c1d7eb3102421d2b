"""The port's launcher end to end on the CPU.

``python -m repro_torch.launch.train --device cpu``: 4 rounds with a
snapshot every 2, then a fresh ``--resume`` for 2 more, must give the
uninterrupted 6-round run's losses bit for bit (tolerance: none — same
seed, same arithmetic, same order).  Flags whose modules wait for later
slices refuse to run; without a GPU the default ``cuda`` device raises,
and so does ``chip_smoke.py``.
"""
from __future__ import annotations

import gc
import shutil
import subprocess
import sys
import weakref
from pathlib import Path

import pytest
import torch

from repro_torch.launch import train

ROOT = Path(__file__).resolve().parents[1]


def test_resume_is_bit_exact(tmp_path):
    out = str(tmp_path / "run")
    a = train.main(["--device", "cpu", "--steps", "4", "--snapshot-every",
                    "2", "--outdir", out])
    r = train.main(["--device", "cpu", "--steps", "2", "--snapshot-every",
                    "2", "--outdir", out, "--resume"])
    full = train.main(["--device", "cpu", "--steps", "6",
                       "--snapshot-every", "2"])
    assert a["losses"] + r["losses"] == full["losses"]
    assert len(full["losses"]) == 6
    assert full["losses"][-1] < full["losses"][0]      # it learns
    manifests = list((tmp_path / "run" / "snaps" / "manifests").glob("*"))
    assert len(manifests) == 3                          # steps 1, 3, 5


def test_faulty_fleet_trains_the_same_losses():
    """Workers that die holding leases or return corrupt results cost
    reissues, never a different model: quorum keeps only validated
    gradients, and each unit's gradient is a pure function of the state
    and its batch."""
    clean = train.main(["--device", "cpu", "--steps", "3",
                        "--snapshot-every", "0"])
    faulty = train.main(["--device", "cpu", "--steps", "3",
                         "--snapshot-every", "0", "--fail-prob", "0.2",
                         "--corrupt-prob", "0.2", "--replication", "3",
                         "--quorum", "2", "--workers", "4"])
    assert faulty["losses"] == clean["losses"]
    assert faulty["scheduler"]["invalid_results"] > 0


def test_replaced_state_is_freed_without_the_cycle_collector():
    """A round's old state, its gradients and its snapshot images are freed
    by reference counting alone: nothing on the path may hold tensors in a
    reference cycle (at full width each leaked image is 5.34 GB)."""
    from repro_torch import tree as tu
    args = train.parse_args(["--device", "cpu", "--snapshot-every", "1"])
    sess = train.build_trainer(train.build_arch(args.arch, args.preset),
                               args)
    tr = sess.trainer
    gc.collect()
    gc.disable()
    try:
        tr.round(0)
        old = [weakref.ref(t) for t in tu.leaves(tr.state)]
        loss, grads = tr.grad_fn(tr.state.params, tr.stream.batch(0))
        grad_refs = [weakref.ref(t) for t in tu.leaves(grads)]
        del loss, grads
        tr.round(1)
        assert not any(r() is not None for r in grad_refs)
        assert not any(r() is not None for r in old)
    finally:
        gc.enable()


def _restore_without_device(device: str):
    """A trainer on ``device`` snapshots at step 1 and moves on a round;
    ``restore_latest`` without ``device`` -> (the snapshot's leaves as
    taken, the restored leaves, the next step)."""
    from repro_torch import tree as tu
    from repro_torch.models import api
    args = train.parse_args(["--device", device, "--snapshot-every", "2"])
    cfg = train.build_arch(args.arch, args.preset)
    tr = train.build_trainer(cfg, args).trainer
    tr.round(0)
    tr.round(1)                                     # snapshots step 1
    taken = [t.clone() for t in tu.leaves(tr.state)]
    tr.round(2)
    nxt = tr.restore_latest(api.state_specs(cfg))
    return taken, tu.leaves(tr.state), nxt


def test_restore_latest_defaults_to_the_trainers_device():
    """Without ``device`` the state comes back where the trainer's state
    lies (here the CPU), equal to the snapshot bit for bit."""
    taken, restored, nxt = _restore_without_device("cpu")
    assert nxt == 2
    assert len(restored) == len(taken)
    for want, got in zip(taken, restored):
        assert got.device.type == "cpu"
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))


@pytest.mark.parametrize("flag", [
    ["--uplink"], ["--compress-grads"], ["--replicas", "1"],
    ["--edge-caches", "1"], ["--shards", "2"], ["--rebalance"],
    ["--telemetry", "tel"], ["--preset", "full"],
])
def test_unported_flags_refuse(flag):
    with pytest.raises(SystemExit, match="not yet ported|TPU-scale"):
        train.main(["--device", "cpu", "--steps", "1", *flag])


def test_default_device_needs_a_gpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--steps", "1"])


def test_chip_smoke_fails_without_gpu_or_checkout(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in ((ROOT, ROOT / "chip_smoke.py"),
                        (tmp_path, tmp_path / "chip_smoke.py")):
        if cwd is tmp_path:
            shutil.copy(ROOT / "chip_smoke.py", script)
        proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                              capture_output=True, text=True, timeout=120)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
