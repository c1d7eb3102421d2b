"""Dry run on one card: trace every (arch × shape) cell at full width on
the meta device and report it against one H100 (the counterpart of
``repro.launch.dryrun``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \
        --shape all --out experiments/dryrun_h100

Each applicable cell is built by ``cell.build_cell`` on ``meta`` (no
storage: the inputs, params, optimizer state and caches are shapes and
dtypes only) and its step runs once under ``flop_analysis.traced_flops``.
A wrong shape, a missing branch or an op the meta device cannot run
surfaces here, in seconds per cell and without a card.  Each cell's JSON
(``{arch}__{shape}__h100[__tag].json``) holds its status, the traced
FLOPs against ``costmodel.analytic_cost``'s model FLOPs, the roofline
against one H100's peak rates, the bytes it needs resident against the
card's 80 GB, and the trace seconds.  A cell ``shape_applicable`` rejects
is ``skipped``, with its reason.

The reference's ``--mesh`` (TPU pod meshes), ``--override`` (sharding
rule overrides) and ``--fsdp-gather`` (FSDP gather-then-compute) have no
counterpart on one card, where every tensor is whole.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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


def cell_bytes(arch, shape, run: RunConfig) -> dict:
    """Bytes a cell needs resident on the card: params, the optimizer
    state (train), the batch, the cache (prefill: the one it writes;
    decode: the one it reads) and the activations of the cost model's
    inventory, and their total."""
    params = api.param_specs(arch)
    train = shape.kind == "train"
    out = {"params": param_bytes(params),
           "opt_state": param_bytes(adamw.state_specs(params)) if train
           else 0,
           "batch": param_bytes(api.input_specs(arch, shape)),
           "cache": 0 if train else param_bytes(api.cache_specs(
               arch, shape.global_batch, shape.seq_len)),
           "activations": int(flop_analysis.activation_bytes(
               arch, shape, run))}
    out["total"] = sum(out.values())
    return out


def run_cell(arch_name: str, shape_name: str, run: RunConfig,
             out_dir: Path, tag: str = "", window: int = 0) -> dict:
    rec = {"arch": arch_name, "shape": shape_name, "device": DEVICE,
           "tag": tag, "run": {"remat": run.remat, "window": window}}
    arch = get_arch(arch_name)
    if window:
        arch = dataclasses.replace(arch, window=window)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(arch, shape)
    if not ok:
        rec.update(status="skipped", reason=why)
    else:
        t0 = time.perf_counter()
        try:
            cell = build_cell(arch, shape, mesh_mod.device_by_name("meta"),
                              run)
            ops = flop_analysis.traced_ops(cell.step, *cell.args)
            trace_s = time.perf_counter() - t0
            cost = costmodel.analytic_cost(arch, shape, 1, run)
            roof = flop_analysis.Roofline(
                flops_per_device=sum(ops.values()),
                hbm_bytes_per_device=cost.hbm_bytes_per_device,
                n_devices=1, model_flops_per_device=cost.model_flops_w_attn,
                fp32_flops_per_device=ops["float32"])
            nbytes = cell_bytes(arch, shape, run)
            rec.update(
                status="ok", trace_s=trace_s, n_devices=1,
                memory_analysis=flop_analysis.memory_dict(cell, run),
                roofline=roof.summary(), bytes=nbytes,
                fits_80gb=nbytes["total"] <= mesh_mod.HBM_BYTES,
                model_flops_global=cost.model_flops)
        except Exception as e:  # a failure here is a bug in the system
            rec.update(status="error", error=f"{type(e).__name__}: {e}",
                       traceback=traceback.format_exc()[-4000:])
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        suffix = f"__{tag}" if tag and rec["status"] != "skipped" else ""
        path = out_dir / f"{arch_name}__{shape_name}__{DEVICE}{suffix}.json"
        path.write_text(json.dumps(rec, indent=2, default=float))
    return rec


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--arch", nargs="+", default=["all"])
    ap.add_argument("--shape", nargs="+", default=["all"])
    ap.add_argument("--out", default="experiments/dryrun_h100")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--tag", default="", help="suffix for output JSONs "
                    "(perf-iteration variants)")
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window attention size: beyond-paper extra "
                         "that makes long_500k traceable for dense archs "
                         "(non-faithful to the source configs; reported "
                         "separately)")
    args = ap.parse_args(argv)

    archs = list_archs() if args.arch == ["all"] else args.arch
    shapes = list(SHAPES) if args.shape == ["all"] else args.shape
    run = RunConfig(remat=args.remat)
    out_dir = Path(args.out)

    results = []
    for a in archs:
        for s in shapes:
            print(f"=== dry-run {a} × {s} × {DEVICE} {args.tag} ===",
                  flush=True)
            rec = run_cell(a, s, run, out_dir, tag=args.tag,
                           window=args.window)
            status = rec["status"]
            extra = ""
            if status == "ok":
                r = rec["roofline"]
                extra = (f" dominant={r['dominant']}"
                         f" compute={r['compute_s']:.3e}s"
                         f" memory={r['memory_s']:.3e}s"
                         f" bytes={rec['bytes']['total']:.3e}"
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
