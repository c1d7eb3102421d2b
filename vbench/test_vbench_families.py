"""CPU tests of the model families found by name
(``reference/families/<family>.py``) and of the reference's memory:
whole runs read the numbers they read before the families moved into
their own files; a family that exists only as a file under another root
runs whole; the reference reads bf16 weights exactly as their float32
copies, upcasting one layer's slice at a time; attention in blocks of
queries equals it whole, under its limit on the scores."""
from __future__ import annotations

import json
import math
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from vbench import control, costs, harness, testing, weights
from vbench import run as vrun
from vbench.drivers.train import arch_config, state_keys
from vbench.reference import families, model
from vbench.reference.precision import F32, FP8
from vbench.reference.train import dotted
from vbench.testing import CPU, SECONDS, SEED, cut, sound, tiny

threads = pytest.fixture(autouse=True, scope="module")(testing.one_thread)

# Read on the CPU at the commit before the families moved into their own
# files (one thread, SEED, a serve window of one batch); the move keeps
# every operation and its order, so they hold to a relative 1e-6.
TRAIN_CHECKS = {"loss_gap": 0.00013722895255533215,
                "grad_norm_gap": 0.0007218270672899697,
                "grad_diff": 0.01067259223871325,
                "change_gap": 0.00047116108630513117}
PINS = {
    "serve": {"served_logit_gap": 0.0, "requests_failed": 0.0,
              "model_flops": 189818880.0},
    "serve_fp8": {"program": 0.0034363269805908203,
                  "control": 0.018833458423614502},
    "train": dict(TRAIN_CHECKS, snapshot_leaves_differing=0.0,
                  flops_per_unit=129073152.0),
    "train_plain": dict(TRAIN_CHECKS, flops_per_unit=129073152.0),
    "train_fp8": {"loss_gap": 0.00034019994631671863,
                  "grad_norm_gap": 0.006285612392277049,
                  "grad_diff": 0.1009317836392093,
                  "change_gap": 0.001699423410930283},
}


@pytest.fixture
def one_batch(monkeypatch):
    """A serve window of exactly one batch: each ``run_queue`` outlasts
    the window, so which requests the check samples is fixed."""
    from repro_torch.serving.engine import ServingEngine
    served = ServingEngine.run_queue

    def then_wait(self, reqs):
        out = served(self, reqs)
        time.sleep(SECONDS)
        return out
    monkeypatch.setattr(ServingEngine, "run_queue", then_wait)


def checks_and_facts(line: dict, facts) -> dict:
    out = {k: c["value"] for k, c in line["checks"].items()}
    out.update({k: line["facts"][k] for k in facts})
    return out


def test_a_served_runs_checks_match_the_pins(one_batch):
    cell = tiny("hymba-1.5b.serve-chat")
    line = vrun.execute(harness.Run(cell=cell, seed=SEED, seconds=SECONDS,
                                    trace=False), CPU, False)
    assert line["facts"]["batches"] == 1
    assert checks_and_facts(line, ["model_flops"]) == \
        pytest.approx(PINS["serve"], rel=1e-6)


def test_the_served_float8_control_matches_the_pins(one_batch):
    cell = tiny("hymba-1.5b.serve-chat")
    cell.config = dict(cell.config, vocab_size=8192)
    cell.traffic = dict(cell.traffic,
                        check=dict(min_tokens=10**9, max_requests=10**9))
    got = control.readings(cell, SEED, SECONDS, CPU, control=FP8)
    got = {k: v["served_logit_gap"] for k, v in got["readings"].items()}
    assert got == pytest.approx(PINS["serve_fp8"], rel=1e-6)


@pytest.mark.parametrize("traffic,pin", [(None, "train"),
                                         ("train-plain", "train_plain")])
def test_a_training_runs_checks_match_the_pins(traffic, pin):
    cell = tiny("granite-3-2b.train-snap", traffic)
    line = vrun.execute(harness.Run(cell=cell, seed=SEED, seconds=SECONDS,
                                    trace=False), CPU, False)
    assert checks_and_facts(line, ["flops_per_unit"]) == \
        pytest.approx(PINS[pin], rel=1e-6)


def test_the_training_float8_control_matches_the_pins():
    got = control.readings(tiny("granite-3-2b.train-snap", "train-plain"),
                           SEED, SECONDS, CPU, control=FP8)
    assert got["readings"]["program"] == pytest.approx(TRAIN_CHECKS,
                                                       rel=1e-6)
    assert got["readings"]["control"] == pytest.approx(PINS["train_fp8"],
                                                       rel=1e-6)


# ------------------------------------------------------ a family by name
TWIN = "dense_twin"
FAMILIES = Path(families.__file__).parent


@pytest.fixture
def twin(tmp_path, monkeypatch):
    """A directory that holds one file, ``dense`` under another name with
    one change, three layers in its CPU cut, put first on the families'
    package path; -> the file."""
    src = (FAMILIES / "dense.py").read_text()
    assert "num_hidden_layers=2)" in src
    file = tmp_path / f"{TWIN}.py"
    file.write_text(src.replace("num_hidden_layers=2)",
                                "num_hidden_layers=3)"))
    monkeypatch.setattr(families, "__path__",
                        [str(tmp_path), *families.__path__])
    yield file
    sys.modules.pop(f"{families.__name__}.{TWIN}", None)


@pytest.mark.parametrize("name", ["granite-3-2b.train-snap",
                                  "hymba-1.5b.serve-chat"])
def test_a_family_added_as_one_file_runs_whole(name, twin):
    cell = harness.load_cell(name)
    dense = harness.load_cell("granite-3-2b.train-snap").config
    cell.config = dict(dense, family=TWIN)
    c = cut(cell).config
    assert c["num_hidden_layers"] == 3
    assert families.of(c).__file__ == str(twin)
    line = vrun.execute(harness.Run(cell=cell, seed=SEED, seconds=SECONDS,
                                    trace=False), CPU, False)
    sound(cell, line)
    assert line["attempted"] > 0 and line["failed"] == 0
    if cell.driver == "train":
        assert line["facts"]["flops_per_unit"] == costs.train_flops(
            c, cell.traffic["batch"], cell.traffic["seq"])


def test_a_configuration_naming_a_missing_family_fails_with_its_path(
        tmp_path):
    root = tmp_path
    shutil.copy(harness.ROOT / "BENCHMARK.json", root)
    for sub in ("configs", "traffic", "workloads"):
        shutil.copytree(harness.HERE / sub, root / "vbench" / sub)
    cfg = root / "vbench" / "configs" / "granite-3-2b-4l.json"
    cfg.write_text(json.dumps(dict(json.loads(cfg.read_text()),
                                   family="no_such_family")))
    with pytest.raises(SystemExit) as err:
        harness.load_cell("granite-3-2b.train-snap", root)
    assert str(FAMILIES / "no_such_family.py") in str(err.value)


def test_a_family_refuses_an_arch_of_another_program_family():
    c = dict(harness.load_cell("granite-3-2b.train-snap").config,
             arch="deepseek-moe-16b")
    with pytest.raises(SystemExit, match="moe"):
        arch_config(c)


def test_the_family_names_its_own_unit_scales():
    hymba = harness.load_cell("hymba-1.5b.serve-chat").config
    granite = harness.load_cell("granite-3-2b.train-snap").config
    key = ".params['layers']['norm_attn']"
    assert weights.rule(key, hymba) == "ones"
    assert weights.rule(key, granite) == "normal"
    assert weights.rule(".params['layers']['ln1']", granite) == "ones"


# --------------------------------------------- the reference's memory
class Upcasts(TorchDispatchMode):
    """Records the shape of every float32 tensor made from a bf16 one."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func is torch.ops.aten._to_copy.default and \
                args[0].dtype == torch.bfloat16 and \
                out.dtype == torch.float32:
            self.shapes.append(tuple(out.shape))
        return out


class Largest(TorchDispatchMode):
    """Records the bytes of the largest tensor any operation makes."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else (out,)):
            if isinstance(t, torch.Tensor):
                self.bytes = max(self.bytes, t.numel() * t.element_size())
        return out


def served_weights(name: str):
    """A tiny cell's configuration and its weights as served (bf16), by
    the program's keys made dotted."""
    from repro_torch.models import api
    c = tiny(name).config
    shapes = {k: tuple(s.shape)
              for k, s in state_keys(api.param_specs(arch_config(c)))}
    w = weights.make(c, shapes, SEED, CPU, torch.bfloat16)
    return c, {dotted(k): x for k, x in w.items()}


def forward(c, w, prec):
    tokens = torch.randint(0, c["vocab_size"], (1, 40),
                           generator=torch.Generator().manual_seed(SEED))
    return model.logits(c, w, model.hidden(c, w, tokens, prec), prec)


@pytest.mark.parametrize("name", ["granite-3-2b.train-snap",
                                  "hymba-1.5b.serve-chat"])
@pytest.mark.parametrize("prec", [F32, FP8], ids=["f32", "fp8"])
def test_the_reference_on_bf16_leaves_equals_it_on_float32_copies(name,
                                                                  prec):
    c, w = served_weights(name)
    w32 = {k: x.float() for k, x in w.items()}
    assert torch.equal(forward(c, w, prec), forward(c, w32, prec))


@pytest.mark.parametrize("name", ["granite-3-2b.train-snap",
                                  "hymba-1.5b.serve-chat"])
def test_no_stacked_leaf_is_upcast_whole(name):
    c, w = served_weights(name)
    stacked = {tuple(x.shape) for k, x in w.items()
               if k.startswith("layers.")}
    slices = {tuple(x.shape[1:]) for k, x in w.items()
              if k.startswith("layers.")}
    whole = max(x.numel() for k, x in w.items() if not k.startswith("layers."))
    with Upcasts() as seen:
        forward(c, w, F32)
    assert slices <= set(seen.shapes)
    assert not stacked & set(seen.shapes)
    assert max(map(math.prod, seen.shapes)) <= max(
        whole, max(map(math.prod, slices)))


def qkv(t: int, h: int = 2, hd: int = 8):
    gen = torch.Generator().manual_seed(t)
    return [torch.randn(1, t, h, hd, generator=gen) for _ in range(3)]


ROW = 4 * 100 * 4          # one query's scores: 4 heads, 100 keys, f32


@pytest.mark.parametrize("score_bytes", [ROW, 7 * ROW, 100 * ROW - 1],
                         ids=["one_row", "ragged", "two_blocks"])
def test_query_blocked_attention_equals_whole_attention(score_bytes):
    c, w = served_weights("granite-3-2b.train-snap")
    assert c["num_attention_heads"] == 4
    x = torch.randn(1, 100, c["hidden_size"],
                    generator=torch.Generator().manual_seed(1))
    whole = model.attention(c, w, 0, x, F32)
    blocked = model.attention(c, w, 0, x, F32, score_bytes=score_bytes)
    assert torch.allclose(blocked, whole, rtol=0, atol=1e-6)


@pytest.mark.parametrize("t", [256, 1000])
def test_attention_makes_no_scores_above_its_limit(t):
    limit = 64 * 1024
    q, k, v = qkv(t)
    with Largest() as whole:
        model.causal_softmax_attention(q, k, v)
    with Largest() as blocked:
        model.causal_softmax_attention(q, k, v, score_bytes=limit)
    assert whole.bytes == 2 * t * t * 4 > limit
    assert blocked.bytes <= limit


def test_no_family_file_loads_the_port_or_jax():
    """Every family file, loaded in a fresh process, leaves no module of
    the port, JAX or the JAX package in ``sys.modules``."""
    code = (
        "import json, sys\n"
        "from vbench import harness\n"
        "from vbench.reference import families\n"
        "from pathlib import Path\n"
        "names = sorted(p.stem for p in Path(families.__file__).parent"
        ".glob('*.py') if p.stem != '__init__')\n"
        "for n in names: families.load(n)\n"
        "top = {m.split('.')[0] for m in sys.modules}\n"
        "print(json.dumps([names, harness.forbidden_modules(),"
        " sorted(top & {'repro_torch'})]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                         env=dict(os.environ, PYTHONPATH=str(harness.ROOT)),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    names, forbidden, port = json.loads(out.stdout)
    assert {"dense", "hybrid"} <= set(names)
    assert forbidden == [] and port == []
