"""Dry run: trace every (arch × shape × mesh) cell at full width on the
meta device and report it against H100s (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --mesh h100 single_pod multi_pod \
        --out experiments/dryrun_h100

Each applicable cell is built by ``cell.build_cell`` on ``meta`` (no
storage: the inputs, params, optimizer state and caches are shapes and
dtypes only) and its step runs once under ``flop_analysis.traced``.  A
wrong shape, a missing branch, an op the meta device cannot run or a
sharding DTensor cannot propagate surfaces here, in seconds per cell and
without a card.  ``--mesh h100`` is one card; ``single_pod`` (16 x 16),
``multi_pod`` (2 x 16 x 16) and ``host`` (1 x 1) are the reference's
meshes, traced in this one process over the in-process ``fake`` backend
with the cell's arguments as meta DTensors at their resolved placements
(``--override`` and ``--fsdp-gather`` change the rules, as the
reference's do).  Each cell's JSON (``{arch}__{shape}__{mesh}[__tag]
.json``) holds its status, the traced FLOPs (global, as the reference's,
and those one device runs, which exceed global / n where a mesh dim
leaves a product replicated) against ``costmodel.analytic_cost``'s model
FLOPs, the collectives DTensor issued (count, output and wire bytes by
op), the roofline against H100 peak and link rates, the bytes one device
holds against the card's 80 GB, and the trace seconds.  A cell
``shape_applicable`` rejects is ``skipped``, with its reason; a cell that
fails is an error, and the run exits 1.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time
import traceback
from pathlib import Path

from repro_torch.configs.base import (SHAPES, get_arch, list_archs,
                                      shape_applicable)
from repro_torch.distributed.sharding import param_bytes
from repro_torch.launch import costmodel, flop_analysis
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.cell import build_cell
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw

DEVICE = "h100"
MESHES = (DEVICE, "host", "single_pod", "multi_pod")


def cell_bytes(arch, shape, run: RunConfig, rules=None) -> dict:
    """Bytes a cell needs resident on one card: params, the optimizer
    state (train), the batch, the cache (prefill: the one it writes;
    decode: the one it reads) and the activations of the cost model's
    inventory, and their total.  With ``rules`` (a mesh) each tree counts
    one device's shards, and the activations the share of the batch
    "act_batch" gives it."""
    params = api.param_specs(arch)
    train = shape.kind == "train"
    out = {"params": param_bytes(params, rules),
           "opt_state": param_bytes(adamw.state_specs(params), rules)
           if train else 0,
           "batch": param_bytes(api.input_specs(arch, shape), rules),
           "cache": 0 if train else param_bytes(api.cache_specs(
               arch, shape.global_batch, shape.seq_len), rules),
           "activations": int(flop_analysis.activation_bytes(
               arch, shape, run) / flop_analysis.batch_shards(rules, shape))}
    out["total"] = sum(out.values())
    return out


def _trace(arch, shape, run: RunConfig, mesh_name: str, rec: dict) -> None:
    """Build and trace the cell on ``mesh_name``; fill ``rec``."""
    if mesh_name == DEVICE:
        cell = build_cell(arch, shape, mesh_mod.device_by_name("meta"), run)
        n_dev = 1
    else:
        cell = build_cell(arch, shape, mesh_mod.make_mesh_by_name(mesh_name),
                          run)
        n_dev = mesh_mod.chips(cell.mesh)
    t0 = time.perf_counter()
    ops, per_device, coll = flop_analysis.traced(cell.step, *cell.args)
    trace_s = time.perf_counter() - t0
    cost = costmodel.analytic_cost(arch, shape, n_dev, run)
    roof = flop_analysis.Roofline(
        flops_per_device=sum(per_device.values()),
        hbm_bytes_per_device=cost.hbm_bytes_per_device,
        n_devices=n_dev,
        model_flops_per_device=cost.model_flops_w_attn / n_dev,
        fp32_flops_per_device=per_device["float32"],
        coll=coll if cell.mesh is not None else None)
    nbytes = cell_bytes(arch, shape, run, cell.rules)
    rec.update(
        status="ok", trace_s=trace_s, n_devices=n_dev,
        traced_flops_global=sum(ops.values()),
        memory_analysis=flop_analysis.memory_dict(cell, run),
        roofline=roof.summary(), bytes=nbytes,
        fits_80gb=nbytes["total"] <= mesh_mod.HBM_BYTES,
        model_flops_global=cost.model_flops)
    if cell.rules is not None:
        rec["run"]["rules"] = {k: v for k, v in cell.rules.rules.items()}


def run_cell(arch_name: str, shape_name: str, run: RunConfig,
             out_dir: Path, tag: str = "", window: int = 0,
             mesh_name: str = DEVICE) -> dict:
    rec = {"arch": arch_name, "shape": shape_name, "mesh": mesh_name,
           "tag": tag, "run": {"remat": run.remat, "window": window,
                               "rules": run.logical_rules or {},
                               "fsdp_gather_weights":
                                   run.fsdp_gather_weights}}
    if mesh_name == DEVICE:
        rec["device"] = DEVICE
    arch = get_arch(arch_name)
    if window:
        arch = dataclasses.replace(arch, window=window)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        try:
            if mesh_name == DEVICE:
                _trace(arch, shape, run, mesh_name, rec)
            else:
                world = math.prod(mesh_mod.MESHES[mesh_name][0])
                with mesh_mod.process_group("fake", world):
                    _trace(arch, shape, run, mesh_name, rec)
        except Exception as e:  # a failure here is a bug in the system
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag and rec["status"] != "skipped" else ""
        path = out_dir / f"{arch_name}__{shape_name}__{mesh_name}{suffix}.json"
        path.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--mesh", nargs="+", default=["single_pod", "multi_pod"],
                    choices=list(MESHES))
    ap.add_argument("--out", default="experiments/dryrun_h100")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--tag", default="", help="suffix for output JSONs "
                    "(perf-iteration variants)")
    ap.add_argument("--override", nargs="*", default=[], metavar="AXIS=MESH",
                    help="sharding-rule overrides for perf iteration, e.g. "
                         "'embed=none' (no FSDP) 'act_seq=model' (SP); "
                         "'none' maps to replication")
    ap.add_argument("--fsdp-gather", action="store_true",
                    help="gather-then-compute FSDP weights (see RunConfig)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention size: beyond-paper extra "
                         "that makes long_500k traceable for dense archs "
                         "(non-faithful to the source configs; reported "
                         "separately)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == ["all"] else args.arch
    shapes = list(SHAPES) if args.shape == ["all"] else args.shape
    overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        overrides[k] = None if v.lower() in ("none", "") else \
            tuple(v.split(",")) if "," in v else v
    run = RunConfig(remat=args.remat, logical_rules=overrides or None,
                    fsdp_gather_weights=args.fsdp_gather)
    out_dir = Path(args.out)

    results = []
    for a in archs:
        for s in shapes:
            for m in args.mesh:
                print(f"=== dry-run {a} × {s} × {m} {args.tag} ===",
                      flush=True)
                rec = run_cell(a, s, run, out_dir, tag=args.tag,
                               window=args.window, mesh_name=m)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    extra = (f" dominant={r['dominant']}"
                             f" compute={r['compute_s']:.3e}s"
                             f" memory={r['memory_s']:.3e}s"
                             f" collective={r['collective_s']:.3e}s"
                             f" bytes/device={rec['bytes']['total']:.3e}"
                             f" fits_80gb={rec['fits_80gb']}"
                             f" (trace {rec['trace_s']:.1f}s)")
                elif status == "error":
                    extra = " " + rec["error"]
                print(f"--> {status}{extra}", flush=True)
                results.append(rec)

    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skipped" for r in results)
    n_err = sum(r["status"] == "error" for r in results)
    print(f"\nTOTAL: {n_ok} ok, {n_skip} skipped (documented), "
          f"{n_err} errors")
    if n_err:
        raise SystemExit(1)
    return results


if __name__ == "__main__":
    main()
