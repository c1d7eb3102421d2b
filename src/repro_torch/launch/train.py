"""V-BOINC training launcher (PyTorch port of ``repro.launch.train``).

Volunteer-scheduled data-parallel training with periodic differencing
snapshots probed on the card, surviving worker failures and restarts:

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-2b \
        --preset smoke --steps 6 --snapshot-every 2 --outdir /tmp/run1
    # crash it, then:
    ... --resume --steps 2       # continues bit-exactly from the snapshot

Runs on ``cuda`` unless ``--device cpu`` is given; with no GPU and no such
request it stops with an error rather than carrying on on the CPU.  On the
card it turns on deterministic algorithms (and ``CUBLAS_WORKSPACE_CONFIG``)
and keeps TF32 off for matmul and cuDNN, so a resumed run's losses equal
an uninterrupted run's bit for bit.

``--preset full`` keeps the assigned architecture and refuses here; the
uplink, gradient compression, replica, edge, sharded-plane and telemetry
flags wait for later slices of the port and raise.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.elastic import SimWorker, VolunteerTrainer
from repro_torch.core.scheduler import SimClock, VolunteerScheduler
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.data.pipeline import DataConfig, TokenStream
from repro_torch.distributed.sharding import init_tree
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw


def build_arch(name: str, preset: str):
    cfg = get_arch(name)
    if preset == "full":
        return cfg
    if preset == "smoke":
        return reduced(cfg)
    if preset == "100m":
        # ~100M-param same-family config (example application scale)
        return reduced(cfg, n_layers=6, d_model=512, n_heads=8,
                       n_kv_heads=4, d_ff=2048, vocab_size=32768)
    raise ValueError(preset)


def resolve_device(name: str) -> torch.device:
    """``cuda`` (the default) needs a GPU and raises without one; the CPU
    runs only when asked for.  On the card, set up deterministic kernels."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available; pass --device cpu "
                               "to run on the CPU")
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--preset", default="smoke",
                    choices=["smoke", "100m", "full"])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a GPU) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8, help="per micro-batch")
    ap.add_argument("--micro", type=int, default=2,
                    help="work units per optimizer step")
    ap.add_argument("--workers", type=int, default=3)
    ap.add_argument("--fail-prob", type=float, default=0.0)
    ap.add_argument("--corrupt-prob", type=float, default=0.0)
    ap.add_argument("--replication", type=int, default=1)
    ap.add_argument("--quorum", type=int, default=1)
    ap.add_argument("--shards", type=int, default=1,
                    help="sharded scheduler plane (not yet ported: > 1 "
                         "raises)")
    ap.add_argument("--rebalance", action="store_true",
                    help="elastic shard policy (not yet ported)")
    ap.add_argument("--watermark", type=int, default=2)
    ap.add_argument("--refill-batch", type=int, default=8)
    ap.add_argument("--snapshot-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8 gradient compression (not yet ported)")
    ap.add_argument("--uplink", action="store_true",
                    help="delta-aware upload path (not yet ported)")
    ap.add_argument("--edge-caches", type=int, default=0,
                    help="edge delta caches (not yet ported: > 0 raises)")
    ap.add_argument("--edge-capacity", type=int, default=1 << 28)
    ap.add_argument("--replicas", type=int, default=0,
                    help="replicated snapshot chains (not yet ported: > 0 "
                         "raises)")
    ap.add_argument("--async-writer", action="store_true",
                    help="zero-stall snapshots: the round pays only the "
                         "device probe + changed-tile transfer; hashing, "
                         "RLE and store writes run on a background writer")
    ap.add_argument("--writer-depth", type=int, default=2,
                    help="bounded queue depth for --async-writer")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="lifecycle tracing dump (not yet ported)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    return ap.parse_args(argv)


def check_ported(args: argparse.Namespace) -> None:
    """Refuse the flags whose modules wait for later slices of the port."""
    for flag, on in (("--uplink", args.uplink),
                     ("--compress-grads", args.compress_grads),
                     ("--replicas", args.replicas > 0),
                     ("--edge-caches", args.edge_caches > 0),
                     ("--shards > 1", args.shards > 1),
                     ("--rebalance", args.rebalance),
                     ("--telemetry", args.telemetry is not None)):
        if on:
            raise SystemExit(f"{flag} is not yet ported to repro_torch")


@dataclass
class Session:
    """What ``build_trainer`` sets up and ``train`` drives."""
    cfg: ArchConfig
    device: torch.device
    trainer: VolunteerTrainer
    snaps: SnapshotManager
    store: ChunkStore
    start_step: int
    spawn: Callable[[int], None]


def make_grad_fn(loss_fn):
    """(params, batch) -> (loss, grads): autograd over detached leaves."""
    def grad_fn(params, batch):
        keys = [k for k, _ in tu.flatten_with_keys(params)]
        leaves = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
        live = tu.unflatten_like(params, dict(zip(keys, leaves)))
        loss = loss_fn(live, batch)
        grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), tu.unflatten_like(params,
                                                dict(zip(keys, grads)))
    return grad_fn


def build_trainer(cfg: ArchConfig, args: argparse.Namespace) -> Session:
    """Everything ``main`` runs, for any ``ArchConfig``: model, optimizer,
    data, scheduler, snapshot store and trainer, restored from the chain
    on disk with ``--resume``."""
    check_ported(args)
    device = resolve_device(args.device)
    run = RunConfig(remat="none", block_kv=min(args.seq, 512), ssm_chunk=64)
    specs = api.state_specs(cfg)
    oc = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=max(args.steps * 2, 100))
    grad_fn = make_grad_fn(api.make_eval_loss(cfg, run))

    def apply_fn(state, grads):
        p, o, _ = adamw.update(oc, grads, state.opt, state.params)
        return api.TrainState(p, o)

    stream = TokenStream(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                    seed=args.seed))
    clock = SimClock()
    root = Path(args.outdir) if args.outdir else None
    store = ChunkStore(root / "store" if root else None)
    snaps = SnapshotManager(store, root=root / "snaps" if root else None,
                            keep_last=3, async_mode=args.async_writer,
                            writer_depth=args.writer_depth)
    sched = VolunteerScheduler(replication=args.replication,
                               quorum=args.quorum, deadline_s=30.0,
                               clock=clock)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = api.TrainState(init_tree(specs.params, gen, device=device),
                           init_tree(specs.opt, gen, device=device))
    trainer = VolunteerTrainer(
        grad_fn=grad_fn, apply_fn=apply_fn, state=state, stream=stream,
        micro_batches=args.micro, scheduler=sched, snapshots=snaps,
        snapshot_every=args.snapshot_every, seed=args.seed)

    start_step = 0
    if args.resume:
        if root is not None:
            # pick up on-disk manifests from the previous process; ordered
            # by (step, created), NOT filename — snapshot ids restart per
            # process, so a resumed run's newest snapshot can sort first
            snaps.load_existing()
        start_step = trainer.restore_latest(specs, device=device)
        print(f"resumed from snapshot at step {start_step}")

    next_id = [0]

    def spawn(n: int) -> None:
        for _ in range(n):
            w = next_id[0]
            next_id[0] += 1
            trainer.add_worker(SimWorker(
                f"vol-{w}", fail_prob=args.fail_prob,
                corrupt_prob=args.corrupt_prob,
                rng=np.random.default_rng((args.seed, w))))

    spawn(args.workers)
    # elastic membership: replacements keep arriving as volunteers churn
    trainer.respawn = lambda tr: spawn(1)
    return Session(cfg, device, trainer, snaps, store, start_step, spawn)


def train(sess: Session, args: argparse.Namespace) -> dict:
    """Run ``args.steps`` rounds from ``sess.start_step``; -> summary."""
    trainer, snaps = sess.trainer, sess.snaps
    t0 = time.time()
    for s in range(sess.start_step, sess.start_step + args.steps):
        alive = sum(w.alive for w in trainer.workers.values())
        if alive < args.workers:
            sess.spawn(args.workers - alive)
        st = trainer.round(s)
        if s % args.log_every == 0:
            print(f"step {st.step:4d} loss {st.loss:.4f} "
                  f"units {st.units} reissued {st.reissued} "
                  f"dup {st.duplicates} invalid {st.invalid} "
                  f"snap_bytes {st.snapshot_bytes} "
                  f"stall_ms {st.snapshot_stall_ms:.1f}")
    snaps.close()                    # drain pending background writes
    if sess.device.type == "cuda":
        torch.cuda.synchronize(sess.device)
    wall = time.time() - t0
    tokens = args.steps * args.micro * args.batch * args.seq
    hist = trainer.history[-args.steps:] if args.steps else []
    summary = {
        "arch": sess.cfg.name, "device": str(sess.device),
        "steps": args.steps, "wall_s": round(wall, 2),
        "tokens_per_s": round(tokens / wall, 1) if wall > 0 else None,
        "final_loss": hist[-1].loss if hist else None,
        "losses": [h.loss for h in hist],
        "scheduler": dict(trainer.sched.stats),
        "store": dict(sess.store.stats),
        "alive_workers": sum(w.alive for w in trainer.workers.values()),
        "snapshot_stall_ms": round(sum(h.snapshot_stall_ms for h in hist), 2),
    }
    if args.async_writer:
        summary["snapshot_writer"] = {
            k: round(v, 2) if isinstance(v, float) else v
            for k, v in snaps.writer_stats.items()}
    print(json.dumps(summary, indent=2))
    if args.outdir:
        (Path(args.outdir) / "summary.json").write_text(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    if args.preset == "full":
        raise SystemExit("--preset full is TPU-scale; the port runs "
                         "reduced presets, or a config passed to "
                         "build_trainer")
    check_ported(args)
    cfg = build_arch(args.arch, args.preset)
    return train(build_trainer(cfg, args), args)


if __name__ == "__main__":
    main()
