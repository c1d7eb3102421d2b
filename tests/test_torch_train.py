"""The port's launcher end to end on the CPU.

``python -m repro_torch.launch.train --device cpu``: 4 rounds with a
snapshot every 2, then a fresh ``--resume`` for 2 more, must give the
uninterrupted 6-round run's losses bit for bit (tolerance: none — same
seed, same arithmetic, same order).  Only ``--preset full`` and an
encoder–decoder ``--arch`` refuse to run (the reference's launcher fails on
the latter at its first unit); without a GPU the default ``cuda`` device
raises, and so does ``chip_smoke.py``.

Against the JAX launcher (``repro.launch.train.main``), both started from
the JAX launcher's initial state (carried across with ``convert.py``): the
uplink, compression, replica, edge, shard, rebalance and telemetry flags
give the same scheduler counters, uplink acceptance and dense bytes,
replication and edge counts and telemetry event kinds, exactly, and
per-step losses within ``LOSS_TOL``.  The losses differ only by float32
rounding in another order (XLA against PyTorch on the CPU): 5.5e-6 at the
first step, growing to at most 2.6e-4 by the twelfth over the default,
uplink and compression modes (measured on the CPU; ~5.5 at the start, so
5e-5 of the loss).
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


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "deepseek-moe-16b"])
def test_resume_is_bit_exact_for_the_ssm_and_moe_families(arch, tmp_path):
    """The SSM and MoE families through the same resume: 2 rounds with a
    snapshot every 1 (a base, then a diff), a fresh ``--resume`` for 1
    more, against 3 uninterrupted rounds, bit for bit."""
    out = str(tmp_path / "run")
    common = ["--device", "cpu", "--arch", arch]
    a = train.main(common + ["--steps", "2", "--snapshot-every", "1",
                             "--outdir", out])
    r = train.main(common + ["--steps", "1", "--snapshot-every", "1",
                             "--outdir", out, "--resume"])
    full = train.main(common + ["--steps", "3", "--snapshot-every", "0"])
    assert a["losses"] + r["losses"] == full["losses"]
    assert len(full["losses"]) == 3


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


@pytest.mark.parametrize("flag", [["--preset", "full"]])
def test_unported_flags_refuse(flag):
    with pytest.raises(SystemExit, match="TPU-scale"):
        train.main(["--device", "cpu", "--steps", "1", *flag])


def test_launcher_refuses_an_encoder_decoder():
    """seamless-m4t-medium is refused up front, by ``--arch`` and by a
    config handed to ``build_trainer``: the token stream has no frames."""
    from repro_torch.configs.base import get_arch, reduced
    with pytest.raises(SystemExit, match="encoder-decoder"):
        train.main(["--device", "cpu", "--arch", "seamless-m4t-medium",
                    "--steps", "1"])
    with pytest.raises(SystemExit, match="encoder-decoder"):
        train.build_trainer(reduced(get_arch("seamless-m4t-medium")),
                            train.parse_args(["--device", "cpu"]))


def test_reference_launcher_fails_on_an_encoder_decoder():
    """The refusal follows the reference: its launcher stops at the first
    unit on the frames its stream does not yield."""
    from repro.launch import train as j_train
    with pytest.raises(KeyError, match="frames"):
        j_train.main(["--arch", "seamless-m4t-medium", "--steps", "1",
                      "--snapshot-every", "0"])


LOSS_TOL = 5e-4


@pytest.fixture
def from_reference_init(monkeypatch, request):
    """Start the port's launcher from the JAX launcher's initial state (seed
    0, the smoke preset of the arch passed as the fixture's parameter,
    granite-3-2b without one), and record the JAX trainer's per-step
    losses; put both packages' default telemetry hubs back afterwards
    (``--telemetry`` installs a tracing one)."""
    import jax
    import numpy as np

    from repro.core import elastic as j_elastic
    from repro.core import telemetry as j_tlm
    from repro.core.snapshots import _flatten as j_flatten
    from repro.distributed.sharding import init_tree as j_init_tree
    from repro.launch import train as j_train
    from repro.models import api as j_api
    from repro_torch import convert
    from repro_torch.core import telemetry as tlm
    from repro_torch.optim.adamw import AdamWState

    arch = getattr(request, "param", "granite-3-2b")
    specs = j_api.state_specs(j_train.build_arch(arch, "smoke"))
    state = j_api.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    port = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in j_flatten(state)}, "cpu")
    monkeypatch.setattr(train, "init_tree", lambda spec, gen, device:
                        port.opt if isinstance(spec, AdamWState)
                        else port.params)
    losses = []
    j_round = j_elastic.VolunteerTrainer.round

    def round_(self, step):
        st = j_round(self, step)
        losses.append(st.loss)
        return st
    monkeypatch.setattr(j_elastic.VolunteerTrainer, "round", round_)
    j_default, t_default = j_tlm.get_default(), tlm.get_default()
    yield j_train, losses
    j_tlm.set_default(j_default)
    tlm.set_default(t_default)


def _event_kinds(path) -> dict:
    import collections
    import json
    return dict(collections.Counter(
        json.loads(line)["kind"] for line in path.read_text().splitlines()))


@pytest.mark.parametrize("flag", [
    ["--uplink"], ["--compress-grads"], ["--replicas", "1"],
    ["--edge-caches", "1"], ["--shards", "2"],
    ["--shards", "2", "--rebalance"], ["--telemetry", "tel"],
])
def test_flags_track_the_reference_launcher(flag, tmp_path,
                                            from_reference_init):
    j_train, j_losses = from_reference_init
    runs = {}
    for name, main in (("jax", j_train.main), ("torch", train.main)):
        argv = ["--steps", "2", "--snapshot-every", "1", *flag]
        if "--telemetry" in flag:
            argv[-1] = str(tmp_path / name)
        if name == "torch":
            argv = ["--device", "cpu", *argv]
        runs[name] = main(argv)
    want, got = runs["jax"], runs["torch"]
    assert len(j_losses) == 2
    assert max(abs(a - b) for a, b in zip(got["losses"], j_losses)) \
        <= LOSS_TOL
    assert got["scheduler"] == want["scheduler"]
    for key in ("replication", "edge", "shard_plane", "rebalance_splits"):
        assert got.get(key) == want.get(key), key
    if "--uplink" in flag:
        for key in ("accepted", "rejected", "dense_bytes"):
            assert got["uplink"][key] == want["uplink"][key], key
        assert got["uplink"]["accepted"] == 4
        assert got["uplink"]["rejected"] == 0
    else:
        assert "uplink" not in got and "uplink" not in want
    if "--telemetry" in flag:
        kinds = _event_kinds(tmp_path / "torch" / "events.jsonl")
        assert kinds == _event_kinds(tmp_path / "jax" / "events.jsonl")
        assert kinds["fold"] == 4
        tel = got["telemetry"]
        assert {k: v for k, v in tel.items() if k != "dir"} == \
            {k: v for k, v in want["telemetry"].items() if k != "dir"}
        for f in ("events.jsonl", "metrics.prom", "trace_summary.txt"):
            assert (tmp_path / "torch" / f).stat().st_size > 0


FAMILIES = ["granite-3-2b", "falcon-mamba-7b", "hymba-1.5b",
            "deepseek-moe-16b", "qwen3-moe-30b-a3b"]


@pytest.mark.parametrize("from_reference_init", FAMILIES, indirect=True)
def test_losses_track_the_jax_trainer(from_reference_init, request):
    """From identical initial params and optimizer state, 8 rounds of the
    launcher on each family's smoke preset (bf16 compute): every step's
    loss within ``LOSS_TOL`` of the JAX trainer's (measured gaps over 8
    steps: granite at most 1.3e-4, falcon 1.7e-4, hymba 1.3e-4, deepseek
    1.2e-4, qwen3-moe 0.8e-4), and the training moves the loss by far
    more than that."""
    j_train, j_losses = from_reference_init
    arch = ["--arch", request.node.callspec.params["from_reference_init"]]
    j_train.main(arch + ["--steps", "8", "--snapshot-every", "0"])
    got = train.main(["--device", "cpu", *arch, "--steps", "8",
                      "--snapshot-every", "0"])["losses"]
    assert len(j_losses) == len(got) == 8
    gaps = [abs(a - b) for a, b in zip(got, j_losses)]
    assert max(gaps) <= LOSS_TOL, gaps
    assert got[0] - got[-1] > 100 * LOSS_TOL


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
