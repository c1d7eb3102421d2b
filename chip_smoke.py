#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --phases build,kernel --layers 2

Phases, each printing one JSON line:

1. ``gpu``: the card's name and power limit (``nvidia-smi``).
2. ``build``: ``nvcc`` of every kernel source of the port, in parallel.
3. ``kernel``: ``fused_delta_tiles`` against its plain PyTorch version, bit
   for bit, on leaves of 1 and 12,320 tiles with ragged tails, every
   kernel dtype, and no / all / first-and-last / a random 10 % of tiles
   changed; then, at the training path's launch shapes, checked again and
   timed with CUDA events beside the plain version and the bytes bound.
4. ``train``: ``repro_torch.launch.train`` at the full width of
   granite-3-2b (d_model 2048, 32 heads, 8 KV heads, d_ff 8192, vocab
   49155) and 4 of its 40 layers: 4 rounds with a snapshot every 2, a
   fresh ``--resume`` for 2 more, and an uninterrupted 6-round run whose
   losses must equal the first two's bit for bit; the newest snapshot must
   restore to the live state's exact bytes, and the kernel's launch
   counter must show the diff snapshot going through it.

Then the ``kernels`` summary line and, last, ``{"ok": true, ...}``.  Any
failed check exits non-zero before that line.  Without a CUDA device it
exits non-zero at once.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory (NVIDIA data sheet)
REPLACES = "src/repro/kernels/delta_encode/kernel.py:151"
SOURCE = "src/repro_torch/kernels/delta_encode/csrc/fused_delta.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def granite_full_width(n_layers: int):
    from repro_torch.configs.base import get_arch, reduced
    return reduced(get_arch("granite-3-2b"), n_layers=n_layers, d_model=2048,
                   n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155)


# ---------------------------------------------------------------- gpu
def phase_gpu() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"gpu": line})
    return line


# -------------------------------------------------------------- build
def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.delta_encode import kernel
    builders = {"fused_delta_tiles": kernel.build}
    with ThreadPoolExecutor(len(builders)) as pool:
        futs = {name: pool.submit(fn, True) for name, fn in builders.items()}
        secs = {name: f.result() for name, f in futs.items()}
    emit({"phase": "build", "seconds": secs,
          "ptxas": kernel.build_log().splitlines()[-12:]})


# ------------------------------------------------------------- kernel
def _mutated(old, pattern: str, gen):
    """Copy of ``old`` with one bit flipped in each selected tile."""
    import torch

    from repro_torch.kernels.delta_encode.kernel import TILE
    new = old.clone()
    bits = new.view(torch.int16 if old.element_size() == 2 else torch.int32)
    per_tile = TILE * 4 // old.element_size()
    n = old.numel()
    ntiles = -(-n // per_tile)
    if pattern == "none":
        return new
    if pattern == "all":
        tiles = torch.arange(ntiles, device=old.device)
    elif pattern == "first_last":
        idx = torch.tensor([0, n - 1], device=old.device)
        bits[idx] ^= 16
        return new
    else:                                           # random 10 %
        tiles = torch.randperm(ntiles, generator=gen,
                               device=old.device)[:max(1, ntiles // 10)]
    offs = torch.randint(0, per_tile, (tiles.numel(),), generator=gen,
                         device=old.device)
    idx = torch.clamp(tiles * per_tile + offs, max=n - 1)
    bits[idx] ^= 16
    return new


def _leaf(dtype, numel: int, gen):
    import torch
    if dtype.is_floating_point:
        return torch.randn(numel, dtype=dtype, device="cuda", generator=gen)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (numel,), dtype=dtype,
                         device="cuda", generator=gen)


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def path_launches(cfg) -> list:
    """Tile counts of the fused launches one diff snapshot of this
    config's train state issues (``ops.plan_buckets`` on the state)."""
    import numpy as np

    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.models import api
    metas = {}
    for key, spec in tu.flatten_with_keys(api.state_specs(cfg)):
        itemsize = spec.dtype.itemsize
        nbytes = int(np.prod(spec.shape, dtype=np.int64)) * itemsize
        n_i32 = -(-nbytes // 4)
        metas[key] = (nbytes, -(-n_i32 // (ops.TILE_BYTES // 4)),
                      ops.dtype_name(spec.dtype))
    out = []
    for bid, leaves in ops.plan_buckets(metas):
        if bid < 0:
            out.extend(nt for _, _, nt, _ in leaves)
        else:
            out.append(sum(nt for _, _, nt, _ in leaves))
    return out


def phase_kernel(cfg, reps: int = 5) -> dict:
    import torch

    from repro_torch.kernels.delta_encode.kernel import (
        TILE, as_i32_tiles, fused_delta_tiles)
    from repro_torch.kernels.delta_encode.ops import (KERNEL_DTYPES,
                                                      TILE_BYTES,
                                                      dtype_from_name)
    from repro_torch.kernels.delta_encode.ref import fused_tiles_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, max_err = 0, 0
    for name in KERNEL_DTYPES:
        dtype = dtype_from_name(name)
        per_tile = TILE * 4 // dtype.itemsize
        for ntiles in (1, 12320):
            numel = (ntiles - 1) * per_tile + per_tile // 2 + 3   # ragged
            old = _leaf(dtype, numel, gen)
            o32, _ = as_i32_tiles(old)
            check(o32.shape[0] == ntiles, f"tile count {o32.shape[0]}")
            for pattern in ("none", "all", "first_last", "random10"):
                new = _mutated(old, pattern, gen)
                n32, _ = as_i32_tiles(new)
                bm, tiles = fused_delta_tiles(o32, n32)
                bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
                torch.cuda.synchronize()
                k = int(bm_ref.sum())
                err = max(int((bm.long() - bm_ref.long()).abs().max()),
                          int((tiles[:k].long() - tiles_ref.long())
                              .abs().max()) if k else 0)
                max_err = max(max_err, err)
                check(torch.equal(bm, bm_ref)
                      and torch.equal(tiles[:k], tiles_ref),
                      f"kernel != plain: {name} {ntiles} tiles {pattern}")
                cases += 1
                del new, n32, bm, tiles, bm_ref, tiles_ref
            del old, o32
    torch.cuda.empty_cache()

    # times at the training path's launch shapes, every tile changed (as
    # AdamW leaves the state), each distinct shape timed once
    launches = path_launches(cfg)
    ms = plain_ms = 0.0
    moved = 0
    for nblk in sorted(set(launches)):
        count = launches.count(nblk)
        o32 = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                            dtype=torch.int32, device="cuda", generator=gen)
        n32 = o32 ^ 1
        bm, tiles = fused_delta_tiles(o32, n32)
        bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
        check(torch.equal(bm, bm_ref) and torch.equal(tiles, tiles_ref),
              f"kernel != plain at the path's shape of {nblk} tiles")
        cases += 1
        del bm, tiles, bm_ref, tiles_ref
        ms += count * _time_ms(lambda: fused_delta_tiles(o32, n32), reps)
        plain_ms += count * _time_ms(lambda: fused_tiles_ref(o32, n32), reps)
        # inputs read once, bitmap + k = nblk tiles written once
        moved += count * (3 * nblk * TILE_BYTES + 4 * nblk)
        del o32, n32
    torch.cuda.empty_cache()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3
    res = {"phase": "kernel", "name": "fused_delta_tiles", "cases": cases,
           "tolerance": "bit for bit", "max_abs_err": max_err, "launches_per_snapshot": len(launches),
           "snapshot_tiles": sum(launches), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "reps": reps}
    emit(res)
    return res


# -------------------------------------------------------------- train
def _state_bytes_equal(a, b) -> bool:
    import torch

    from repro_torch import tree as tu
    fa, fb = tu.flatten_with_keys(a), tu.flatten_with_keys(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return False
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(fa, fb))


def _round_breakdown(trainer) -> dict:
    """Host-clock ms of one unit's parts on a trained session (second of
    two calls, synchronised): the gradient, its quorum hash (device to
    host copy + blake2b) and the optimizer step."""
    import torch

    from repro_torch.core.elastic import grad_hash

    def timed(fn):
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    batch = trainer.stream.batch(0)
    (_, grads), grad_ms = timed(
        lambda: trainer.grad_fn(trainer.state.params, batch))
    _, hash_ms = timed(lambda: grad_hash(grads))
    _, apply_ms = timed(lambda: trainer.apply_fn(trainer.state, grads))
    return {"grad_fn": grad_ms, "grad_hash": hash_ms, "apply": apply_ms,
            "units_per_round": trainer.micro_batches}


def _peak_gb() -> float:
    """Peak device memory allocated since the last call, in GB."""
    import torch
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return peak


def _release() -> None:
    """Free a finished session's device memory: a session's trainer and
    its respawn closure refer to each other, so only the cycle collector
    frees them."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _finite(state) -> bool:
    import torch

    from repro_torch import tree as tu
    return all(bool(torch.isfinite(x).all()) for x in tu.leaves(state)
               if x.is_floating_point())


def phase_train(cfg, workdir: Path) -> dict:
    import torch

    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    from repro_torch.launch import train

    outdir = str(workdir / "run")
    per_diff = len(path_launches(cfg))
    res = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "free_disk_gb": shutil.disk_usage(workdir).free / 1e9}

    # ---- the main path: every count to 0 just before, read just after
    fused_delta_tiles.launches = 0
    ops.reset_kernel_stats()
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args_a = train.parse_args(["--steps", "4", "--snapshot-every", "2",
                               "--outdir", outdir])
    sess = train.build_trainer(cfg, args_a)
    res["params"] = sum(p.numel() for p in tu.leaves(sess.trainer.state.params))
    sum_a = train.train(sess, args_a)
    kinds = [sess.snaps.manifests[s].kind for s in sess.snaps.order]
    check(kinds == ["base", "diff"], f"snapshot kinds {kinds}")
    diff_info = sess.snaps.last_info
    stats_a = dict(ops.KERNEL_STATS)
    launches_a = fused_delta_tiles.launches
    peaks["train_4"] = _peak_gb()
    t_restore = time.perf_counter()
    restored, _ = sess.snaps.restore(target_tree=sess.trainer.state,
                                     device=sess.device)
    res["restore_s"] = time.perf_counter() - t_restore
    check(_state_bytes_equal(restored, sess.trainer.state),
          "restore of the diff snapshot != live state")
    peaks["restore"] = _peak_gb()
    del restored, sess
    _release()

    args_r = train.parse_args(["--steps", "2", "--snapshot-every", "2",
                               "--outdir", outdir, "--resume"])
    sess = train.build_trainer(cfg, args_r)
    check(sess.start_step == 4, f"resumed at {sess.start_step}")
    sum_r = train.train(sess, args_r)
    restored, _ = sess.snaps.restore(target_tree=sess.trainer.state,
                                     device=sess.device)
    check(_state_bytes_equal(restored, sess.trainer.state),
          "restore of the resumed run's snapshot != live state")
    check(_finite(sess.trainer.state), "non-finite state after training")
    peaks["resume_2"] = _peak_gb()
    del restored, sess
    _release()

    args_b = train.parse_args(["--steps", "6", "--snapshot-every", "0"])
    sess = train.build_trainer(cfg, args_b)
    sum_b = train.train(sess, args_b)
    peaks["train_6_no_snapshots"] = _peak_gb()
    launches = fused_delta_tiles.launches
    res["main_path_s"] = time.perf_counter() - t0
    res["round_ms"] = _round_breakdown(sess.trainer)
    del sess
    _release()

    losses = sum_a["losses"] + sum_r["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # random init: the first loss sits near ln(vocab)
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]} vs ln V {math.log(cfg.vocab_size)}")
    check(losses == sum_b["losses"],
          f"resumed losses {losses} != uninterrupted {sum_b['losses']}")
    check(launches_a == per_diff and launches == per_diff,
          f"kernel launches {launches_a}/{launches}, expected {per_diff} "
          "for the one diff snapshot")
    res.update({
        "losses": losses, "losses_bit_exact": True, "restore_exact": True,
        "launches": launches, "launches_per_diff_snapshot": per_diff,
        "tokens_per_s_with_snapshots": sum_a["tokens_per_s"],
        "tokens_per_s_no_snapshots": sum_b["tokens_per_s"],
        "diff_snapshot": {
            "kernel_ms": stats_a["kernel_ms"], "d2h_ms": stats_a["d2h_ms"],
            "probe_bytes": stats_a["probe_bytes"],
            "d2h_bytes": stats_a["d2h_bytes"],
            "plan_ms": diff_info.plan_ms, "stall_ms": diff_info.stall_ms,
            "bound_ms": (stats_a["probe_bytes"] + stats_a["d2h_bytes"])
            / HBM_BYTES_PER_S * 1e3},
        "peak_mem_gb": peaks,
    })
    emit(res)
    return res


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phases", default="build,kernel,train")
    ap.add_argument("--layers", type=int, default=4)
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    cfg = granite_full_width(args.layers)

    phase_gpu()
    if "build" in phases:
        phase_build()
    kern = phase_kernel(cfg) if "kernel" in phases else None
    tr = None
    if "train" in phases:
        workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            tr = phase_train(cfg, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)
    if kern is not None and tr is not None:
        emit({"kernels": [{
            "name": "fused_delta_tiles", "route": "cuda", "source": SOURCE,
            "replaces": REPLACES, "launches": tr["launches"],
            "max_abs_err": kern["max_abs_err"], "ms": kern["ms"],
            "plain_ms": kern["plain_ms"], "bound_ms": kern["bound_ms"],
            "bound_by": "bytes", "library_ms": None}]})
        emit({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
