"""Readings that the limits of ``correct`` are set from, for one cell.

    python3 -m vbench.control --workload <cell> --seeds 1,2,3 [--seconds 0]
        [--control fp8] [--fault unchanged|half_batch|token] [--traffic <mix>]

For each seed, in one process: the cell's set-up, a window of
``--seconds`` (a serving cell needs one to serve anything; a training
cell's numbers come from its set-up's first steps, so 0 will do), and its
check.  One JSON line per seed holds the program's readings, and with
``--control fp8`` the control's: the plain reference computed with its
projections in float8 (``reference/precision.py``), put in the program's
place over the same inputs, with the control's own verdict against the
cell's limits (``control_correct``).  ``--traffic`` reads the cell's
model under another mix of ``traffic/``: a training cell's numbers come
from its first three steps, which its snapshots never change, so
``train-plain`` reads them without a snapshot's drain.  ``--fault``
breaks the timed path instead: ``unchanged`` makes each step return its
state unchanged, ``half_batch`` folds only the first half of each
round's units (the mean taken over them), ``token`` turns each decoded
token into the one its logits rank last, where it is produced.  The
benchmark's own runs never run any of this.  Run on the card, or on the
CPU by the tests (``device``).
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from vbench import harness
from vbench.harness import Run
from vbench.reference.precision import FP8

FAULTS = ("unchanged", "half_batch", "token")


def break_path(ses, fault: str) -> None:
    """Plant ``fault`` under the window's entry of a set-up session."""
    import torch
    if fault == "unchanged":
        ses.trainer.apply_fn = lambda state, grads: state
    elif fault == "half_batch":
        grad_fn, half = ses.trainer.grad_fn, ses.tr["micro"] // 2
        now = {"params": None, "outs": [], "n": 0}

        def first_half(params, batch):
            # a round's units share its params and come in order: the
            # second half returns the first half's results, so the fold's
            # mean is theirs
            if params is not now["params"]:
                now.update(params=params, outs=[], n=0)
            n = now["n"]
            now["n"] += 1
            if n >= half:
                return now["outs"][n % half]
            out = grad_fn(params, batch)
            now["outs"].append(out)
            return out
        ses.trainer.grad_fn = first_half
    elif fault == "token":
        decode, vocab = ses.engine._decode, ses.c["vocab_size"]

        def altered(*args):
            logits, caches = decode(*args)
            logits = logits.clone()
            rows = torch.arange(logits.shape[0], device=logits.device)
            least = logits[:, 0, :vocab].argmin(-1)
            logits[rows, 0, least] = logits.max() + 1
            return logits, caches
        ses.engine._decode = altered
    else:
        raise ValueError(f"unknown fault {fault!r}")


def readings(cell, seed: int, seconds: float, device, control=None,
             fault: str = None) -> dict:
    """One seed's set-up, window and check on ``device``; -> the readings
    and the run (its ``checks`` against the cell's limits)."""
    drv = harness.driver_module(cell.driver)
    run = Run(cell=cell, seed=seed, seconds=seconds, trace=False)
    if fault in ("unchanged", "half_batch"):
        # broken before the first steps, which the check compares
        ses = drv.Session(run, device)
        break_path(ses, fault)
        ses.first_steps()
    else:
        ses = drv.setup(run, device)
        if fault is not None:
            break_path(ses, fault)
    drv.window(ses, run)
    got = drv.check(ses, run, control)
    del ses
    gc.collect()
    out = {"seed": seed, "readings": got, "correct": run.correct,
           "checks": {k: list(v) for k, v in run.checks.items()}}
    if control is not None:
        # the control in the program's place, against the same limits
        ctl = Run(cell=cell, seed=seed, seconds=seconds, trace=False)
        for k, v in got["control"].items():
            ctl.check(k, v, cell.limits[k])
        out.update(control_correct=ctl.correct,
                   control_checks={k: list(v) for k, v in ctl.checks.items()})
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=0.0)
    ap.add_argument("--control", choices=("fp8",), default=None)
    ap.add_argument("--fault", choices=FAULTS, default=None)
    ap.add_argument("--traffic", default=None)
    args = ap.parse_args(argv)
    from vbench.run import prepare_environment
    cell = harness.load_cell(args.workload)
    if args.traffic:
        cell.traffic = harness.load_json(
            harness.HERE / "traffic" / f"{args.traffic}.json")
    prepare_environment()
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("vbench.control: no CUDA device")
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        out = readings(cell, seed, args.seconds, torch.device("cuda", 0),
                       FP8 if args.control else None, args.fault)
        out["seconds"] = time.perf_counter() - t
        print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    sys.stdout.flush()


if __name__ == "__main__":
    main()
