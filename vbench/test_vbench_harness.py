"""CPU tests of the benchmark's harness: ``BENCHMARK.json`` against the
contract's rules, every file a cell needs found by name, the metric
arithmetic on synthetic timelines, the cost formulas against hand counts,
the isolation from JAX and the JAX package, and the refusal without a
CUDA device.  None needs a card, ``nvcc`` or ``triton``."""
from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from vbench import costs, harness, stats
from vbench.drivers import serve as serve_driver

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
CELLS = [w["name"] for w in BENCH["workloads"]]


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32
    assert all(line_ok(w) and not w.startswith("/") and ".." not in w
               for w in BENCH["command"])
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert not p.endswith("_torch") and (ROOT / p).is_dir()
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits the driver's 43,200 s
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_every_name_unit_and_text_is_allowed():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = [m["name"] for m in metrics]
    for group in (names, CELLS, [c["name"] for c in BENCH["configs"]]):
        assert len(group) == len(set(group))
        assert all(NAME.match(n) for n in group)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line_ok(m["layer"]) and m["source"] in SOURCES
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert all(w in CELLS for w in m.get("workloads", []))
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(BENCH)) <= 64 * 1024


def test_files_under_paths_are_named_from_name_characters():
    for f in (ROOT / "vbench").rglob("*"):
        if "__pycache__" in f.parts:
            continue
        assert re.fullmatch(r"[A-Za-z0-9_./-]+",
                            str(f.relative_to(ROOT))), f


def test_reduced_keys_name_no_width_and_exist():
    width = re.compile(r"(_dim$|_rank$|_size$|^intermediate|expand|"
                       r"experts_per_tok|d_state|d_conv)")
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        for key in c["reduced"]:
            assert key in cfg and not width.search(key), key
            assert key in cfg.get("published", {}), key


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_are_found_by_name(cell):
    c = harness.load_cell(cell)
    mod = harness.driver_module(c.driver)
    assert callable(mod.setup) and callable(mod.window)
    assert callable(mod.check)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2 and c.per_layer
    for m in c.per_layer:
        assert m["moves"] in e2e
        assert callable(harness.metric_reader(m["name"]))
    assert c.limits and all(isinstance(v, (int, float))
                            for v in c.limits.values())


def test_every_config_is_used_by_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("values,q,want", [
    ([1.0], 90, 1.0),
    ([3.0, 1.0, 2.0], 50, 2.0),
    (list(range(11)), 90, 9.0),
    ([0.0, 10.0], 95, 9.5),
])
def test_percentile_is_numpys_linear(values, q, want):
    assert stats.percentile(values, q) == pytest.approx(want)


def test_a_stall_in_the_window_lowers_the_rate_and_raises_the_tail():
    # rounds of 1 s; a 2 s stall after the second
    ends = [1.0, 2.0, 5.0, 6.0]
    rate, work, secs = stats.completed_rate(0.0, ends, [10] * 4, 6.5)
    assert (rate, work, secs) == (40 / 6.0, 40, 6.0)
    plain, _, _ = stats.completed_rate(0.0, [1.0, 2.0, 3.0, 4.0],
                                       [10] * 4, 6.5)
    assert plain == 10.0 and rate < plain
    # a round that ends after the window is not counted
    assert stats.completed_rate(0.0, ends, [10] * 4, 5.5)[1] == 30
    steady = [[0.0, 0.1, 0.2, 0.3]] * 20
    stalled = steady[:-1] + [[0.0, 0.1, 2.1, 2.2]]
    assert stats.percentile(stats.token_gaps(steady), 95) == \
        pytest.approx(0.1)
    assert stats.percentile(stats.token_gaps(stalled), 99) > 0.5
    assert stats.batch_rate(0.0, 4.0, 100) == 25.0


def test_the_rate_counts_whole_snapshot_periods():
    # rounds of 1 s, a 2 s stall in every second round; the window ends
    # after the third round, mid-period, so the rate stops at the second
    ends = [1.0, 4.0, 5.0, 8.0]
    rate, work, secs = stats.completed_rate(0.0, ends, [10] * 4, 6.0, 2)
    assert (rate, work, secs) == (20 / 4.0, 20, 4.0)
    # two whole periods read the same rate as one
    assert stats.completed_rate(0.0, ends, [10] * 4, 8.0, 2)[0] == rate
    # fewer rounds than a period: nothing completed
    assert stats.completed_rate(0.0, ends, [10] * 4, 2.0, 2) == (0.0, 0.0,
                                                               0.0)


def test_spread_is_the_quartile_distance_over_the_median():
    vals = [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]
    q1, med, q3 = 1.75, 3.5, 5.25
    assert stats.spread(vals) == pytest.approx((q3 - q1) / med)


def test_attention_and_scan_work_by_hand():
    # causal, t = s = 4: 10 (query, key) pairs; 4 ops each per head dim
    assert costs.attn_flops(1, 1, 4, 4, 1, True) == 40
    assert costs.attn_flops(2, 3, 4, 6, 8, False) == 4 * 2 * 3 * 8 * 24
    # t > s: s(s+1)/2 + (t-s)s
    assert costs.attn_flops(1, 1, 5, 3, 1, True) == 4 * (6 + 6)
    w = costs.attn_work(1, 2, 2, 4, 2, 8, True, 2)
    assert w["bytes"] == 2 * 8 * (2 * 1 * 4 * 2 + 2 * 1 * 2 * 2)
    assert w["bound_s"] == max(w["ops"] / 989e12, w["bytes"] / 3.35e12)
    assert costs.ssm_flops(1, 2, 3, 4) == 6 * 24 + 6
    s = costs.ssm_work(1, 2, 3, 4, 4)
    assert s["bytes"] == 4 * 3 * 6 + 4 * (2 * 8 + 12 + 12)
    d = costs.delta_work(10, 10)
    assert d["bytes"] == 30 * 32768 + 40          # 3N: every tile changed
    assert d["bound_s"] == d["bytes"] / 3.35e12


def test_model_flops_by_hand():
    c = {"hidden_size": 4, "vocab_size": 10, "num_attention_heads": 2,
         "num_key_value_heads": 1, "head_dim": 2, "intermediate_size": 6,
         "num_hidden_layers": 3, "family": "dense"}
    layer = 4 * 4 + 2 * 4 * 2 + 4 * 4 + 3 * 4 * 6
    assert costs.matmul_params(c) == 3 * layer + 40
    assert costs.attn_fwd_flops(c, 3, 0) == 3 * 4 * 2 * 2 * 6
    assert costs.attn_fwd_flops(c, 1, 5) == 3 * 4 * 2 * 2 * 6
    assert costs.train_flops(c, 2, 3) == 6 * (3 * layer + 40) * 6 \
        + 3 * 2 * 3 * 4 * 2 * 2 * 6
    assert costs.prefill_flops(c, 3) == 2 * (3 * layer + 40) * 3 \
        + 3 * 4 * 4 * 6
    h = dict(c, family="hybrid", mamba_expand=2, mamba_d_state=2,
             mamba_dt_rank=1, mamba_d_conv=4)
    di = 8
    ssm = 4 * 16 + di * 4 + di * 5 + di + di * 2 + di + di * 4
    assert costs.matmul_params(h) == costs.matmul_params(c) + 3 * ssm


def test_the_published_configs_match_their_model_cards():
    g = json.loads((ROOT / "vbench/configs/granite-3-2b-4l.json").read_text())
    # granite-3-2b at its 40 layers: 2.53e9 parameters, the head tied to
    # the embedding (counted once, as the head's product)
    assert g["tie_word_embeddings"]
    n = costs.matmul_params(dict(g, num_hidden_layers=40))
    assert 2.5e9 < n < 2.6e9
    h = json.loads((ROOT / "vbench/configs/hymba-1.5b.json").read_text())
    assert 1.4e9 < costs.matmul_params(h) < 1.8e9


def test_the_serving_schedule_is_the_same_for_every_seed():
    spec = {"median": 384, "sigma": 1.0, "min": 64, "max": 2048}
    a = serve_driver.schedule(spec, 64, 24)
    assert a == serve_driver.schedule(spec, 64, 24)
    assert min(a) == 64 and max(a) == 2048 and len(a) == 64
    assert sorted(a)[32] in range(370, 400)


def test_forbidden_names_are_compared_whole():
    assert harness.forbidden_modules(["repro_torch.models", "numpy"]) == []
    assert harness.forbidden_modules(["repro.models.lm", "jax.numpy",
                                      "jaxlib", "flax.core"]) == \
        ["flax", "jax", "jaxlib", "repro"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT / "src"), str(ROOT)])
    env.pop("JAX_PLATFORMS", None)
    return env


def test_nothing_loads_jax_or_the_jax_package():
    """The harness, every reader, the references and the port's modules
    that the drivers call, imported in a fresh process."""
    readers = sorted(p.stem for p in (ROOT / "vbench/metrics").glob("*.py"))
    code = (
        "import sys\n"
        "import vbench.run, vbench.control, vbench.trace, vbench.readouts\n"
        "import vbench.drivers.train, vbench.drivers.serve\n"
        "import vbench.reference.model, vbench.reference.train\n"
        "import vbench.reference.serve, vbench.reference.precision\n"
        "import repro_torch.launch.train, repro_torch.serving.engine\n"
        "import repro_torch.kernels.delta_encode.ops\n"
        "import repro_torch.kernels.flash_attention.ops\n"
        "import repro_torch.kernels.ssm_scan.ops\n"
        "from vbench import harness\n"
        f"for r in {readers!r}: harness.metric_reader(r)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_command_refuses_to_run_without_cuda():
    out = subprocess.run(
        [sys.executable, "-m", "vbench.run", "--workload", CELLS[0],
         "--seed", str(2**31 + 7), "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=dict(_env(), CUDA_VISIBLE_DEVICES=""),
        capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout == "" and "CUDA" in out.stderr


def test_the_roofline_reader_returns_nothing_without_a_trace():
    c = harness.load_cell(CELLS[0])
    run = harness.Run(cell=c, seed=1, seconds=1.0, trace=True)
    run.call("fused_delta_tiles", nblk=4, changed=4)
    for m in c.per_layer:
        assert harness.metric_reader(m["name"])(run) is None
    assert math.isclose(costs.delta_work(4, 4)["bytes"], 12 * 32768 + 16)


def test_device_busy_time_and_idle_gaps_on_a_synthetic_trace():
    from vbench.trace import DeviceTrace
    t = DeviceTrace()
    # overlapping kernels count once; gaps go to the shortest span
    t.events = [("k1", 0.5, 1.0), ("k2", 0.8, 1.2), ("k1", 2.0, 3.0),
                ("k3", 6.0, 7.0)]
    out = t.summary(0.0, 5.0, {"round": [(0.0, 5.0)],
                               "hash": [(1.2, 2.0)]})
    assert out["busy_s"] == pytest.approx(1.7)
    assert out["window_s"] == 5.0
    assert dict(out["breakdown"]["idle_gaps"]) == pytest.approx(
        {"round": 0.5 + 2.0, "hash": 0.8})
    assert dict(out["breakdown"]["device_ops"]) == pytest.approx(
        {"k1": 1.5, "k2": 0.4})
    assert t.kernel_seconds(0.0, 5.0, "k1") == pytest.approx(1.5)
