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

``--uplink`` streams each unit's quantized gradient through the project
server's chunk store as delta refs (the image diffed on the card);
``--compress-grads``, ``--replicas N``, ``--edge-caches N``, ``--shards
N`` with ``--rebalance`` and ``--telemetry DIR`` work as in the reference
launcher; ``--telemetry`` also writes the hub's wall-clock spans as
``spans.jsonl``.  ``--preset full`` keeps the assigned architecture and
refuses here, pointing to the dry run (``python -m
repro_torch.launch.dryrun``), which traces it at full width on the meta
device.  ``--arch`` takes any decoder-only family: dense, MoE
(deepseek-moe-16b, qwen3-moe-30b-a3b), SSM (falcon-mamba-7b) and hybrid
(hymba-1.5b); an encoder–decoder (seamless-m4t-medium) is refused up
front, since the token stream yields no frames (the reference's launcher
fails on them at its first unit).
"""
from __future__ import annotations

import argparse
import json
import os
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, get_arch, reduced
from repro_torch.core import telemetry as tlm
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
                    help="shard the scheduler plane by account-key range "
                         "across N VolunteerScheduler shards (watermark "
                         "refill + work stealing; dispatch stays O(1) as "
                         "the fleet grows)")
    ap.add_argument("--rebalance", action="store_true",
                    help="elastic shard policy: after each round, split "
                         "the hottest shard into the coldest when its "
                         "backlog runs 2x ahead (needs --shards > 1)")
    ap.add_argument("--watermark", type=int, default=2,
                    help="per-volunteer pending-queue low watermark "
                         "(sharded plane only)")
    ap.add_argument("--refill-batch", type=int, default=8,
                    help="leases pulled per watermark refill scan "
                         "(sharded plane only)")
    ap.add_argument("--snapshot-every", type=int, default=10)
    ap.add_argument("--compress-grads", action="store_true",
                    help="int8+error-feedback gradient compression (4x "
                         "smaller volunteer result uploads)")
    ap.add_argument("--uplink", action="store_true",
                    help="delta-aware upload path: volunteers stream "
                         "quantized gradient deltas through the server's "
                         "chunk store; only changed blocks move up")
    ap.add_argument("--edge-caches", type=int, default=0,
                    help="edge delta caches fronting the snapshot store; "
                         "restore_latest routes through their discovery "
                         "service instead of the primary")
    ap.add_argument("--edge-capacity", type=int, default=1 << 28,
                    help="per-cache capacity in bytes (LRU by closure)")
    ap.add_argument("--replicas", type=int, default=0,
                    help="replicate snapshot chains to N peer stores "
                         "(async, bounded outbox); the run survives a "
                         "primary store loss")
    ap.add_argument("--async-writer", action="store_true",
                    help="zero-stall snapshots: the round pays only the "
                         "device probe + changed-tile transfer; hashing, "
                         "RLE and store writes run on a background writer")
    ap.add_argument("--writer-depth", type=int, default=2,
                    help="bounded queue depth for --async-writer")
    ap.add_argument("--telemetry", default=None, metavar="DIR",
                    help="enable lifecycle tracing; writes events.jsonl "
                         "(flight recorder), spans.jsonl (wall-clock "
                         "spans), metrics.prom (Prometheus text "
                         "exposition) and trace_summary.txt "
                         "(trace_reduce post-mortem) into DIR at exit")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=1)
    return ap.parse_args(argv)


def check_ported(args: argparse.Namespace,
                 cfg: Optional[ArchConfig] = None) -> None:
    """Refuse what the port does not run: ``--preset full``, and an
    encoder–decoder (``--arch``, or ``cfg`` where given), whose batches
    need frames that ``TokenStream`` does not yield; the reference's
    launcher stops on the missing frames at its first unit."""
    if args.preset == "full":
        raise SystemExit("--preset full is TPU-scale; trace its cells "
                         "with python -m repro_torch.launch.dryrun, or "
                         "pass a cut config to build_trainer")
    cfg = cfg or get_arch(args.arch)
    if cfg.enc_dec:
        raise SystemExit(f"{cfg.name} is an encoder-decoder: the launcher's "
                         "token stream has no frames; train it through a "
                         "capsule or api.make_train_step")


@dataclass
class Session:
    """What ``build_trainer`` sets up and ``train`` drives."""
    cfg: ArchConfig
    device: torch.device
    trainer: VolunteerTrainer
    snaps: SnapshotManager
    store: Any                      # ChunkStore, or the ReplicaSet over it
    start_step: int
    spawn: Callable[[int], None]
    replicas: Any = None            # ReplicaSet (--replicas)
    edge: Any = None                # EdgeTier (--edge-caches)
    server: Any = None              # VBoincServer (--uplink)
    tel_dir: Optional[Path] = None  # --telemetry


def build_trainer(cfg: ArchConfig, args: argparse.Namespace) -> Session:
    """Everything ``main`` runs, for any ``ArchConfig``: model, optimizer,
    data, scheduler, snapshot store and trainer, restored from the chain
    on disk with ``--resume``."""
    check_ported(args, cfg)
    device = resolve_device(args.device)
    run = RunConfig(remat="none", block_kv=min(args.seq, 512), ssm_chunk=64)
    specs = api.state_specs(cfg)
    oc = adamw.AdamWConfig(lr=args.lr, warmup_steps=10,
                           total_steps=max(args.steps * 2, 100))
    grad_fn = api.make_grad_fn(api.make_eval_loss(cfg, run))

    def apply_fn(state, grads):
        p, o, _ = adamw.update(oc, grads, state.opt, state.params)
        return api.TrainState(p, o)

    stream = TokenStream(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                    seed=args.seed))
    # one shared clock for the scheduler AND the telemetry hub: with a
    # fixed seed the flight-recorder stream is byte-identical across runs
    clock = SimClock()
    tel_dir = Path(args.telemetry) if args.telemetry else None
    if tel_dir is not None:
        tel_dir.mkdir(parents=True, exist_ok=True)
        tlm.set_default(tlm.Telemetry(tracing=True, clock=clock))
    root = Path(args.outdir) if args.outdir else None
    store = ChunkStore(root / "store" if root else None)
    replicas = None
    if args.replicas > 0:
        from repro_torch.core.replica import ReplicaSet
        peers = [ChunkStore(root / f"replica{i}" if root else None)
                 for i in range(args.replicas)]
        # the set IS the snapshot store: writes land on the primary and
        # fan out through the bounded outbox the trainer pumps per round
        store = replicas = ReplicaSet(store, peers)
    snaps = SnapshotManager(store, root=root / "snaps" if root else None,
                            keep_last=3, async_mode=args.async_writer,
                            writer_depth=args.writer_depth)
    if args.shards > 1:
        from repro_torch.core.shardplane import ShardedScheduler
        sched = ShardedScheduler(shards=args.shards,
                                 replication=args.replication,
                                 quorum=args.quorum, deadline_s=30.0,
                                 watermark=args.watermark,
                                 refill_batch=args.refill_batch,
                                 clock=clock)
    else:
        sched = VolunteerScheduler(replication=args.replication,
                                   quorum=args.quorum, deadline_s=30.0,
                                   clock=clock)
    edge = None
    if args.edge_caches > 0:
        from repro_torch.core.edge import EdgeCache, EdgeTier
        # read-only delta caches fronting the snapshot store: the
        # trainer's restore path drains from their discovery service, and
        # they earn scheduler transfer credit for the bytes they serve
        edge = EdgeTier(store,
                        [EdgeCache(f"edge-{i}",
                                   capacity_bytes=args.edge_capacity)
                         for i in range(args.edge_caches)],
                        scheduler=sched)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = api.TrainState(init_tree(specs.params, gen, device=device),
                           init_tree(specs.opt, gen, device=device))

    server = None
    if args.uplink:
        # the volunteer project server: results come back as delta refs
        # through its chunk store instead of bare hashes
        from repro_torch.core.capsule import CapsuleSpec
        from repro_torch.core.server import Project, VBoincServer
        server = VBoincServer(ChunkStore())
        spec = CapsuleSpec(args.arch, "train_4k", run, arch_override=cfg)
        server.publish(Project("train", spec, scheduler=sched))
        server.register_user("launcher")

    trainer = VolunteerTrainer(
        grad_fn=grad_fn, apply_fn=apply_fn, state=state, stream=stream,
        micro_batches=args.micro, scheduler=sched, snapshots=snaps,
        snapshot_every=args.snapshot_every, seed=args.seed,
        compress_grads=args.compress_grads,
        server=server, project="train" if server else None,
        uplink=args.uplink, replicas=replicas, edge=edge)

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
    return Session(cfg, device, trainer, snaps, store, start_step, spawn,
                   replicas, edge, server, tel_dir)


def train(sess: Session, args: argparse.Namespace) -> dict:
    """Run ``args.steps`` rounds from ``sess.start_step``; -> summary."""
    trainer, snaps, sched = sess.trainer, sess.snaps, sess.trainer.sched
    t0 = time.time()
    rebalance_splits = 0
    for s in range(sess.start_step, sess.start_step + args.steps):
        alive = sum(w.alive for w in trainer.workers.values())
        if alive < args.workers:
            sess.spawn(args.workers - alive)
        st = trainer.round(s)
        if args.rebalance and args.shards > 1:
            moved = sched.rebalance()
            if moved is not None:
                rebalance_splits += 1
                print(f"step {s:4d} rebalance: split shard "
                      f"{moved['split']} -> {moved['target']} "
                      f"({moved['slots']} slots, "
                      f"{moved['reassigned_open']} open units)")
        if s % args.log_every == 0:
            up = (f" up {st.uplink_moved}/{st.uplink_dense}"
                  if args.uplink else "")
            print(f"step {st.step:4d} loss {st.loss:.4f} "
                  f"units {st.units} reissued {st.reissued} "
                  f"dup {st.duplicates} invalid {st.invalid} "
                  f"snap_bytes {st.snapshot_bytes} "
                  f"stall_ms {st.snapshot_stall_ms:.1f}{up}")
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
    if args.shards > 1:
        summary["shard_plane"] = sched.shard_report()
        if args.rebalance:
            summary["rebalance_splits"] = rebalance_splits
    if args.async_writer:
        summary["snapshot_writer"] = {
            k: round(v, 2) if isinstance(v, float) else v
            for k, v in snaps.writer_stats.items()}
    if sess.replicas is not None:
        sess.replicas.flush()        # durability: drain the outbox on exit
        summary["replication"] = {**dict(sess.replicas.rstats),
                                  **sess.replicas.replication_report()}
    if sess.edge is not None:
        summary["edge"] = {
            **{k: int(v) for k, v in dict(sess.edge.stats).items()},
            "caches": sess.edge.describe()}
    if sess.server is not None:
        log = sess.server.uplinks.get("train")
        summary["uplink"] = {
            "bytes_in": log.bytes_in if log else 0,
            "bytes_dedup": log.bytes_dedup if log else 0,
            "accepted": log.accepted if log else 0,
            "rejected": log.rejected if log else 0,
            "dense_bytes": sum(h.uplink_dense for h in hist),
            "worker_credit": {w: round(i.credit, 3) for w, i in
                              trainer.sched.workers.items()},
        }
    if sess.tel_dir is not None:
        tel = tlm.get_default()
        n_events = trainer.dump_flight_recorder(sess.tel_dir / "events.jsonl")
        tel.dump_spans_jsonl(sess.tel_dir / "spans.jsonl")
        (sess.tel_dir / "metrics.prom").write_text(tel.prometheus())
        report = tlm.trace_reduce(tel)
        (sess.tel_dir / "trace_summary.txt").write_text(
            report.summary() + "\n")
        summary["telemetry"] = {
            "dir": str(sess.tel_dir), "events": n_events,
            "reissues": report.reissues,
            "attribution_rate": round(report.attribution_rate, 4),
            "anomalies": report.anomaly_kinds(),
        }
    print(json.dumps(summary, indent=2))
    if args.outdir:
        (Path(args.outdir) / "summary.json").write_text(json.dumps(summary))
    return summary


def main(argv=None) -> dict:
    args = parse_args(argv)
    check_ported(args)
    cfg = build_arch(args.arch, args.preset)
    return train(build_trainer(cfg, args), args)


if __name__ == "__main__":
    main()
