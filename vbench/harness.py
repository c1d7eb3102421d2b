"""What every cell shares: finding a cell's files by name, the spans and
counters a run records around its calls into the port, the result line.

A run is one process.  Its set-up (``setup_s``) runs from the process's
start, as the kernel's process table gives it, to the first timed instant.
"""
from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

from vbench.reference import families

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_age_s() -> float:
    """Seconds since this process started (``/proc/self/stat`` field 22,
    in clock ticks since boot, against ``/proc/uptime``)."""
    with open("/proc/self/stat") as f:
        fields = f.read().rsplit(")", 1)[1].split()
    start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start


def forbidden_modules(modules=None) -> List[str]:
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that the benchmark's process must not hold."""
    names = {m.split(".", 1)[0] for m in (modules or sys.modules)}
    return sorted(names & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One entry of ``workloads`` with the files it names."""
    name: str
    chips: int
    config: dict            # configs/<config>.json
    traffic: dict           # traffic/<traffic>.json
    limits: dict            # workloads/<cell>.json "limits"
    end_to_end: List[dict]  # the end-to-end metrics this cell reports
    per_layer: List[dict]   # the per-layer metrics this cell reports

    @property
    def driver(self) -> str:
        return self.traffic["driver"]


def load_benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    """An end-to-end metric without ``workloads`` is every cell's; a
    per-layer metric names its cells."""
    return cell in metric.get("workloads", [cell])


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"vbench: no cell {name!r} in BENCHMARK.json; "
                         f"cells: {sorted(cells)}")
    w = cells[name]
    cfg = {c["name"]: c for c in bench["configs"]}[w["config"]]
    here = root / "vbench"
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    config = load_json(root / cfg["file"])
    families.of(config)           # a family without its file fails here
    return Cell(name=name, chips=w["chips"], config=config,
                traffic=load_json(here / "traffic" / f"{w['traffic']}.json"),
                limits=load_json(here / "workloads" / f"{name}.json")["limits"],
                end_to_end=e2e, per_layer=layer)


def driver_module(kind: str):
    return importlib.import_module(f"vbench.drivers.{kind}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(run) -> float | None`` of ``metrics/<name>.py``."""
    path = root / "vbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"vbench_metric_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


# ---------------------------------------------------------------- records
class Spans:
    """Host-clock intervals by name, recorded around calls into the port
    (``time.perf_counter`` seconds), and counters by name."""

    def __init__(self):
        self.spans: Dict[str, List[tuple]] = {}
        self.counters: Dict[str, list] = {}

    def add(self, name: str, start: float, end: float) -> None:
        self.spans.setdefault(name, []).append((start, end))

    def count(self, name: str, value) -> None:
        self.counters.setdefault(name, []).append(value)

    def get(self, name: str) -> List[tuple]:
        return self.spans.get(name, [])

    def wrap(self, name: str, fn: Callable, sync: Optional[Callable] = None,
             after: Optional[Callable] = None) -> Callable:
        """``fn`` timed as span ``name``; ``sync`` (the device's
        synchronise) runs before the end is read, ``after(args, out)``
        may record what the call did."""
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            if sync is not None:
                sync()
            self.add(name, t0, time.perf_counter())
            if after is not None:
                after(args, out)
            return out
        return timed


@dataclass
class Run:
    """What a driver hands the metric readers and the result line."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    spans: Spans = field(default_factory=Spans)
    window: tuple = (0.0, 0.0)        # host perf_counter of start, end
    setup_s: float = 0.0
    e2e: Dict[str, float] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0
    checks: Dict[str, tuple] = field(default_factory=dict)  # name -> (v, lim)
    kernel_calls: Dict[str, list] = field(default_factory=dict)
    device: Optional[dict] = None     # device trace summary (trace runs)
    tracer: Optional[object] = None   # the DeviceTrace of a traced window
    traced: tuple = (0.0, 0.0)        # the part of the window it traced
    facts: Dict[str, float] = field(default_factory=dict)  # driver numbers

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    def call(self, kernel: str, **work) -> None:
        """One launch of a kernel, with the work its bound counts; while
        a device trace runs, or on a run without one."""
        if self.tracer is None or self.tracer.active:
            self.kernel_calls.setdefault(kernel, []).append(work)

    def check(self, name: str, value: float, limit: float) -> None:
        """A number compared, with its limit: correct while value <= limit."""
        self.checks[name] = (float(value), float(limit))

    @property
    def correct(self) -> bool:
        return bool(self.checks) and all(
            v == v and v <= lim for v, lim in self.checks.values())


def result_line(run: Run, metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict]) -> dict:
    out = {"correct": run.correct, "attempted": run.attempted,
           "failed": run.failed, "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["facts"] = run.facts
    out["checks"] = {k: {"value": v, "limit": lim}
                     for k, (v, lim) in run.checks.items()}
    return out
