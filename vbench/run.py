"""Run one cell of the benchmark once and print its result line.

    python3 -m vbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  With ``--trace 0`` the line's metrics are
the cell's end-to-end metrics; with ``--trace 1`` its per-layer metrics,
read from the spans, counters and device trace of the same window.  The
run fails, and prints no result, without as many CUDA devices as the cell
asks for, or if JAX or the JAX package was loaded.  The numbers compared
for ``correct`` are printed beside their limits as the last lines on
standard error, and under ``checks``, the line's last key.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys

from vbench import harness
from vbench.harness import ROOT, Run


def parse(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str, code: int = 2) -> None:
    print(f"vbench: {msg}", file=sys.stderr)
    raise SystemExit(code)


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout
        return out.splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def prepare_environment() -> None:
    """The port's sources on the path.  Its kernels build with ``nvcc``
    into their own fixed ``build/`` directories inside the checkout."""
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def execute(run: Run, device, trace_on: bool) -> dict:
    """Set-up, window and check of one run on ``device``; -> the result
    line.  ``device`` is "cuda" in every run of the command; the CPU tests
    call it with the CPU."""
    import time

    import torch

    from vbench.trace import DeviceTrace
    drv = harness.driver_module(run.cell.driver)
    ses = drv.setup(run, device)
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    run.setup_s = harness.process_age_s()
    t_setup = time.perf_counter()
    tracer = DeviceTrace() if trace_on and on_card else None
    run.tracer = tracer
    if tracer is not None:
        with tracer:
            drv.window(ses, run)
    else:
        drv.window(ses, run)
    peak = torch.cuda.max_memory_allocated(device) if on_card else 0
    if tracer is not None:
        run.traced = (run.window[0], min(run.window[1], tracer.t_stop))
        run.device = tracer.summary(*run.traced, run.spans.spans)
    t_check = time.perf_counter()
    drv.check(ses, run)
    del ses
    gc.collect()
    run.facts["phase_s"] = {"setup": run.setup_s,
                            "window": t_check - t_setup,
                            "check": time.perf_counter() - t_check}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(device) if on_card else "cpu",
           "count": run.cell.chips, "memory_peak_bytes": int(peak),
           "power_limit": power_limit() if on_card else None}
    metrics, breakdown = {}, None
    if run.trace:
        for m in run.cell.per_layer:
            value = harness.metric_reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if run.device is not None:
            dev["busy_s"] = run.device["busy_s"]
            dev["window_s"] = run.device["window_s"]
            breakdown = run.device["breakdown"]
    else:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    return harness.result_line(run, metrics, dev, breakdown)


def main(argv=None) -> None:
    args = parse(argv)
    cell = harness.load_cell(args.workload)
    prepare_environment()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < cell.chips:
        fail(f"{cell.name} needs {cell.chips} CUDA devices, "
             f"{torch.cuda.device_count()} present")
    run = Run(cell=cell, seed=args.seed, seconds=args.seconds,
              trace=bool(args.trace))
    line = execute(run, torch.device("cuda", 0), bool(args.trace))
    loaded = harness.forbidden_modules()
    if loaded:
        fail(f"modules that must not load were loaded: {loaded}", 3)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
