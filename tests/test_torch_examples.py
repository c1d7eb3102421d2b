"""The port's three examples (``examples/torch_*.py``) against the
reference's (``examples/{quickstart,project_switch,serve_capsule}.py``).

Each port example runs at ``device="cpu"`` and passes its own asserts
(the loss falls by 0.5 under the faulty fleet; the base disk's
re-snapshot stores 0 new bytes; task A resumes bit for bit; pause and
unpause keep the caches).  Where the reference's initial tree matters it
is handed in through ``repro_torch.convert`` (``main(state=...)``):

* quickstart: the capsule it publishes is the reference's, manifest hash
  and all;
* project_switch: the base disk's manifests (all but the clock) equal the
  reference example's, captured from its ``DiskSet``.  The task disks hold
  params and AdamW moments after 6 training steps, whose last bits differ
  between the frameworks (float32 summation order), so for them the
  manifests' layout (disks, snapshots, steps, kinds, tensor keys, shapes,
  dtypes and block counts) is held, not the content refs;
* serve_capsule: the greedy tokens equal the reference example's from the
  same params.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path

import jax
import numpy as np
import torch

from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.core import capsule as j_capsule
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
from repro_torch.kernels.ssm_scan.kernel import ssm_scan

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def _load(name: str):
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _jparams(cfg, seed: int = 0):
    return j_init_tree(japi.param_specs(cfg), jax.random.key(seed))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in j_flatten(tree)}


def test_quickstart_trains_under_a_faulty_fleet_from_the_reference_capsule(
        monkeypatch):
    mod = _load("torch_quickstart")
    published = []

    class Recording(mod.VBoincServer):
        def publish(self, project):
            published.append(project.capsule)
            return super().publish(project)

    monkeypatch.setattr(mod, "VBoincServer", Recording)
    cfg = j_reduced(j_get_arch("granite-3-2b"))
    jspec = j_capsule.CapsuleSpec("granite-3-2b", "train_4k",
                                  JRunConfig(remat="none"),
                                  arch_override=cfg)
    specs = japi.state_specs(cfg)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    launches = fused_delta_tiles.launches
    trainer = mod.main(device="cpu",                   # asserts the loss
                       state=convert.state_from_numpy(_flat(jstate), "cpu"))
    assert [c.manifest_hash for c in published] == [jspec.manifest_hash]
    assert len(trainer.history) == 30
    # a snapshot every 5 rounds, the newest 2 kept
    snaps = trainer.snapshots
    assert [snaps.manifests[s].step for s in snaps.order] == [24, 29]
    assert fused_delta_tiles.launches == launches      # the CPU route


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


def _layout(manifests: dict) -> dict:
    return {name: [{**{k: v for k, v in m.items() if k != "tensors"},
                    "tensors": {key: (ent["shape"], ent["dtype"],
                                      len(ent["refs"]))
                                for key, ent in m["tensors"].items()}}
                   for m in mans]
            for name, mans in manifests.items()}


def _capturing(monkeypatch, mod) -> list:
    seen = []

    class Capturing(mod.DiskSet):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            seen.append(self)

    monkeypatch.setattr(mod, "DiskSet", Capturing)
    return seen


def test_project_switch_disks_match_the_reference_example(monkeypatch):
    ref = _load("project_switch")
    port = _load("torch_project_switch")
    ref_sets, port_sets = _capturing(monkeypatch, ref), \
        _capturing(monkeypatch, port)
    ref.main()
    cfg = j_reduced(j_get_arch("qwen2-1.5b"))
    params = convert.tree_from_numpy(_flat(_jparams(cfg)), "cpu")
    port.main(device="cpu", state=params)
    (jd,), (td,) = ref_sets, port_sets
    want, got = _disk_manifests(jd), _disk_manifests(td)
    assert got["base"] == want["base"]
    assert _layout(got) == _layout(want)
    assert [dataclasses.asdict(d) for d in td.disks()] == \
        [dataclasses.asdict(d) for d in jd.disks()]


def test_serve_capsule_tokens_equal_the_reference_example(capsys):
    _load("serve_capsule").main()
    ref_out = capsys.readouterr().out
    want = json.loads(re.search(r"first request tokens: (\[.*\])",
                                ref_out).group(1))
    cfg = j_reduced(j_get_arch("falcon-mamba-7b"))
    params = convert.tree_from_numpy(_flat(_jparams(cfg)), "cpu")
    launches = ssm_scan.launches
    gen = _load("torch_serve_capsule").main(device="cpu", state=params)
    out = capsys.readouterr().out
    assert gen.shape == (4, 12)
    assert gen[0].tolist() == want
    assert "vm:pause -> suspended" in out and "vm:unpause -> running" in out
    assert ssm_scan.launches == launches               # the CPU route
