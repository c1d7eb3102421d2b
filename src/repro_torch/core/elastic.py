"""Elastic volunteer training: the full V-BOINC loop on real torch compute.

One logical training job runs across an *unreliable* simulated volunteer
fleet: the scheduler leases micro-batch work units (replication + quorum),
workers execute the real gradient function, the trainer combines
validated gradient contributions, applies the optimizer, and the
SnapshotManager takes periodic differencing snapshots.  Worker kills,
corrupt results and mid-run crash/restore are all exercised; determinism of
the data pipeline + gradient computation makes recovery bit-exact.

On a real fleet each worker is a pod running the same capsule; here they are
in-process actors — the protocol (leases, quorum hashes, back-off, recovery)
is identical.

A unit's gradients stay on the device they were computed on: in uplink
mode they are quantized there, and the quantized image is diffed there
(``core/uplink.py``); only the quorum hash and the store objects are
host work.
"""
from __future__ import annotations

import hashlib
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core import telemetry as tlm
from repro_torch.core.control import CapsuleRuntime, Coordinator, HostSupervisor
from repro_torch.core.scheduler import SimClock, VolunteerScheduler
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.core.uplink import DEFAULT_UPLINK_CHUNK, UplinkEncoder
from repro_torch.data.pipeline import Cursor, TokenStream
from repro_torch.optim import grad_compress


def grad_hash(tree, *, tel: Optional[tlm.Telemetry] = None) -> str:
    """blake2b over every leaf's bytes, in flatten order (host copies).
    Each leaf's copy and its digest are spans ``trainer.hash.copy`` and
    ``trainer.hash.digest`` on ``tel`` (by default the default hub)."""
    tel = tlm.resolve(tel)
    h = hashlib.blake2b()
    for leaf in tu.leaves(tree):
        flat = leaf.detach().reshape(-1).view(torch.uint8)
        with tel.span("trainer.hash.copy"):
            host = flat.cpu().numpy()
        with tel.span("trainer.hash.digest"):
            h.update(memoryview(host))
        del host        # freed before the next leaf's copy (up to 0.4 GB)
    return h.hexdigest()


@dataclass
class SimWorker:
    """A volunteer host: speed, failure and corruption behaviour."""
    worker_id: str
    fail_prob: float = 0.0        # dies while holding a lease
    corrupt_prob: float = 0.0     # returns a wrong result (caught by quorum)
    rng: np.random.Generator = field(
        default_factory=lambda: np.random.default_rng(0))
    alive: bool = True
    supervisor: Optional[HostSupervisor] = None


@dataclass
class RoundStats:
    """Per-round snapshot, derived from telemetry-registry deltas: every
    field below is ``after - before`` of a registry counter (scheduler,
    replica or trainer scope) bracketing the round — no hand-threaded
    per-round accumulators."""
    step: int
    loss: float
    units: int
    reissued: int
    duplicates: int
    invalid: int
    snapshot_bytes: int = 0
    snapshot_stall_ms: float = 0.0   # trainer-visible snapshot time only
    replicated: int = 0          # replication messages pumped this round
    # sharded scheduler plane accounting (0 on a single scheduler)
    steals: int = 0              # work-steal batches this round
    refills: int = 0             # watermark refill batches this round
    # delta-aware uplink accounting (0 unless uplink mode is on)
    uplink_dense: int = 0        # int8 payload had volunteers sent it whole
    uplink_moved: int = 0        # deduped bytes actually transferred up
    uplink_dedup: int = 0        # bytes the server already held
    lease_expiries: int = 0      # deadline-driven lease losses this round
    read_repairs: int = 0        # objects healed from peers this round


class VolunteerTrainer:
    """Synchronous-round volunteer data parallelism with full fault handling."""

    def __init__(self, *, grad_fn: Callable, apply_fn: Callable,
                 state, stream: TokenStream, micro_batches: int,
                 scheduler: Optional[VolunteerScheduler] = None,
                 snapshots: Optional[SnapshotManager] = None,
                 snapshot_every: int = 0, seed: int = 0,
                 compress_grads: bool = False,
                 server=None, project: Optional[str] = None,
                 uplink: bool = False,
                 uplink_chunk_bytes: int = DEFAULT_UPLINK_CHUNK,
                 replicas=None, edge=None,
                 telemetry: Optional[tlm.Telemetry] = None):
        """grad_fn(params, batch)->(loss, grads); apply_fn(state, grads)->state.

        ``scheduler`` may be a single ``VolunteerScheduler`` or a
        ``ShardedScheduler`` plane (``core/shardplane.py``) — the trainer
        drives both through the same request/report/drain interface; with
        a plane, each loop sweep is one quorum-validation batch and
        ``RoundStats.steals``/``refills`` report cross-shard traffic.

        ``compress_grads``: int8 + error-feedback compression of the combined
        gradient before the optimizer — the volunteer-uplink analogue of the
        cross-pod trick in optim/grad_compress.py (4x fewer bytes a volunteer
        would upload; the residual is carried on the coordinator).

        ``uplink``: the delta-aware upload path.  Each worker quantizes its
        unit gradient to int8 on its device (stateless, so replicas agree
        bitwise), diffs the quantized image against its own previous round
        with the fused probe, and reports delta refs through
        ``server.report_result`` — only objects the server lacks move, and
        workers are credited by the deduped bytes they actually
        transferred.  Requires ``server`` (a VBoincServer) + ``project``
        (published there); the project's scheduler is used so quorum
        validation and uplink folding share one unit table.

        ``replicas``: a ``ReplicaSet`` whose primary backs the snapshot
        store.  Snapshot/uplink writes only *enqueue* on the hot path; the
        trainer pumps the outbox once per round, after the optimizer step
        and snapshot complete, so peer I/O never blocks a round.

        ``edge``: an ``EdgeTier`` fronting the snapshot store.
        ``restore_latest`` routes its download through edge discovery, so
        a re-attach wave drains from the caches instead of the primary
        (``last_restore_plan['route']`` records who served it)."""
        self.grad_fn = grad_fn
        self.apply_fn = apply_fn
        self.compress_grads = compress_grads
        self._compress_err = None
        self.state = state
        self.stream = stream
        self.micro_batches = micro_batches
        self.server = server
        self.project = project
        self.uplink = uplink
        self.uplink_chunk_bytes = uplink_chunk_bytes
        if uplink and (server is None or project is None):
            raise ValueError("uplink mode needs server= and project=")
        if server is not None and project is not None:
            proj_sched = server.projects[project].scheduler
            if scheduler is None:
                scheduler = proj_sched
            elif scheduler is not proj_sched:
                raise ValueError("trainer scheduler must be the project's "
                                 "scheduler when a server is attached")
        self.sched = scheduler or VolunteerScheduler(clock=SimClock())
        self.replicas = replicas
        self.edge = edge
        self.snapshots = snapshots
        self.snapshot_every = snapshot_every
        self.cursor = Cursor()
        self.coordinator = Coordinator()
        self.workers: Dict[str, SimWorker] = {}
        self._rng = np.random.default_rng(seed)
        self._grad_cache: Dict[str, tuple] = {}   # result_hash -> (loss, grads)
        self._completed: Dict[int, str] = {}      # drained, not yet consumed
        self._uplink_enc: Dict[str, UplinkEncoder] = {}   # per volunteer
        # uplink accounting lives in the registry; RoundStats reads deltas
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("trainer")
        self.tmetrics = scope.counters("uplink_dense", "uplink_moved",
                                       "uplink_dedup", "folds")
        self.tstats = scope.view()
        # unit -> {worker: (moved, dedup)} awaiting quorum validation
        self._pending_credit: Dict[int, Dict[str, tuple]] = {}
        self.last_restore_plan: Optional[dict] = None
        self.history: List[RoundStats] = []
        # elastic membership: called when the fleet empties — a real
        # volunteer project keeps receiving new volunteers
        self.respawn: Optional[Callable[["VolunteerTrainer"], None]] = None
        # fault-injection hook (ChurnSim): called after every dispatch
        # sweep inside round(), while reports are still buffered and
        # leases may be open — the window where a mid-round shard kill
        # or worker loss is observable
        self.on_sweep: Optional[Callable[["VolunteerTrainer", int],
                                         None]] = None

    # ---------------- fleet management ----------------
    def add_worker(self, worker: SimWorker) -> None:
        runtime = CapsuleRuntime(worker.worker_id)
        sup = HostSupervisor(worker.worker_id, runtime)
        sup.control_vm("startvm")
        worker.supervisor = sup
        self.coordinator.register(sup)
        self.workers[worker.worker_id] = worker
        self.sched.join(worker.worker_id)

    def kill_worker(self, worker_id: str) -> None:
        w = self.workers.get(worker_id)
        if w is not None:
            w.alive = False
            w.supervisor.control_vm("poweroff")
            self.sched.leave(worker_id)

    # ---------------- one unit on one worker ----------------
    def _execute_unit(self, worker: SimWorker, unit) -> None:
        with self.tel.span("trainer.unit"):
            batch = self.stream.batch(unit.payload["batch_index"])
            loss, grads = self.grad_fn(self.state.params, batch)
            if self.uplink:
                self._execute_unit_uplink(worker, unit, float(loss), grads)
                return
            h = grad_hash(grads, tel=self.tel)
            if worker.rng.random() < worker.corrupt_prob:
                h = "corrupt-" + h[:16]        # wrong result; quorum rejects
            else:
                self._grad_cache[h] = (float(loss), grads)
            self.sched.report(worker.worker_id, unit.unit_id, h)

    def _execute_unit_uplink(self, worker: SimWorker, unit,
                             loss: float, grads) -> None:
        """Report a unit as a quantized delta stream, not a bare hash.

        Quantization is stateless per unit (no error feedback on the
        worker) so replicated units agree bitwise and quorum validation
        still works; the canonical gradient is the dequantized image the
        server can itself reconstruct from the ingested refs.  Quantizing,
        dequantizing and the image diff run on the gradients' device."""
        wid = worker.worker_id
        comp, _ = grad_compress.compress(grads, grad_compress.init_error(grads))
        grads = grad_compress.decompress(comp, grads)
        h = grad_hash(grads, tel=self.tel)
        if worker.rng.random() < worker.corrupt_prob:
            h = "corrupt-" + h[:16]        # wrong result; quorum rejects
        else:
            self._grad_cache[h] = (loss, grads)
        enc = self._uplink_enc.setdefault(wid, UplinkEncoder(
            chunk_bytes=self.uplink_chunk_bytes))
        update = enc.encode(comp)
        store = self.server.store
        log0 = dict(store.uplinks.get(wid, {}))
        self.server.report_result(self.project, wid, unit.unit_id, h,
                                  update=update)
        log1 = store.uplinks.get(wid, {})
        enc.gc()        # the client store only needs the latest round
        moved = log1.get("bytes_in", 0) - log0.get("bytes_in", 0)
        dedup = log1.get("bytes_dedup", 0) - log0.get("bytes_dedup", 0)
        self.tmetrics.uplink_dense.inc(update.dense_bytes)
        self.tmetrics.uplink_moved.inc(moved)
        self.tmetrics.uplink_dedup.inc(dedup)
        if moved or dedup:
            # credit settles only after quorum validates this worker's
            # result (_settle_uplink_credit) — an always-invalid worker
            # must not farm transfer credit by pushing valid-looking bytes
            self._pending_credit.setdefault(unit.unit_id, {})[wid] = (
                moved, dedup)

    def _settle_uplink_credit(self, drained) -> None:
        """Grant deferred transfer credit for quorum-validated units:
        only workers whose result matched the canonical hash earn by the
        deduped bytes they moved."""
        for uid, _h in drained:
            unit = self.sched.units.get(uid)
            for wid, (mv, dd) in self._pending_credit.pop(uid, {}).items():
                if unit is not None \
                        and unit.results.get(wid) == unit.canonical:
                    self.sched.credit_transfer(wid, mv, dd)

    # ---------------- one synchronous round ----------------
    def _stat_snapshot(self) -> Dict[str, dict]:
        """Registry counters RoundStats derives its per-round deltas from:
        scheduler (or plane aggregate), replica set, trainer scope."""
        snap = {"sched": dict(self.sched.stats),
                "trainer": dict(self.tstats)}
        if self.replicas is not None:
            snap["replica"] = dict(self.replicas.rstats)
        return snap

    @staticmethod
    def _delta(before: Dict[str, dict], after: Dict[str, dict],
               group: str, key: str) -> int:
        return (after.get(group, {}).get(key, 0)
                - before.get(group, {}).get(key, 0))

    def round(self, step: int) -> RoundStats:
        """One synchronous round: every unit of ``step`` executed and
        validated, the fold, the optimizer step, the snapshot when due."""
        with self.tel.span("trainer.round"):
            return self._round(step)

    def _round(self, step: int) -> RoundStats:
        base_index = self.cursor.next_index
        for k in range(self.micro_batches):
            self.sched.submit(step * self.micro_batches + k,
                              {"batch_index": base_index + k, "step": step})
        self.cursor.next_index += self.micro_batches

        before = self._stat_snapshot()
        guard = 0
        while not self.sched.done():
            guard += 1
            if guard > 100_000:
                raise RuntimeError("scheduler did not converge")
            progressed = False
            for w in list(self.workers.values()):
                if not w.alive or not w.supervisor.runtime.accepting_work:
                    continue
                unit = self.sched.request_work(w.worker_id)
                if unit is None:
                    continue
                progressed = True
                if self._rng.random() < w.fail_prob:
                    self.kill_worker(w.worker_id)   # dies holding the lease
                    continue
                self._execute_unit(w, unit)
            if self.on_sweep is not None:
                self.on_sweep(self, step)
            if not progressed:
                # everyone is backing off or leases are pending: advance the
                # simulated clock past back-off windows and lease deadlines
                if isinstance(self.sched.clock, SimClock):
                    self.sched.clock.advance(
                        max(self.sched.backoff_max_s, self.sched.deadline_s)
                        + 1.0)
                else:
                    self.sched._expire_leases(self.sched.clock() + 1e9)
                if not any(w.alive for w in self.workers.values()):
                    if self.respawn is not None:
                        self.respawn(self)
                    if not any(w.alive for w in self.workers.values()):
                        raise RuntimeError("all volunteers died")

        # combine validated canonical results — drain only the units that
        # completed since last round
        drained = self.sched.drain_completed()
        self._settle_uplink_credit(drained)
        self._completed.update(drained)
        round_units = sorted(uid for uid in self._completed
                             if uid // self.micro_batches == step)
        losses, grads = [], None
        with self.tel.span("trainer.update"):
            for uid in round_units:
                loss, g = self._grad_cache[self._completed.pop(uid)]
                self.tmetrics.folds.inc()
                if self.tel.tracing:
                    self.tel.event("fold", unit=uid, round=step)
                losses.append(loss)
                grads = g if grads is None else tu.tree_map(
                    lambda a, b: a + b, grads, g)
            grads = tu.tree_map(lambda g: g / self.micro_batches, grads)
            if self.compress_grads:
                if self._compress_err is None:
                    self._compress_err = grad_compress.init_error(grads)
                comp, self._compress_err = grad_compress.compress(
                    grads, self._compress_err)
                grads = grad_compress.decompress(comp, grads)
            self.state = self.apply_fn(self.state, grads)
            self._grad_cache.clear()

        snapshot_stall_ms, snapshot_bytes = 0.0, 0
        if (self.snapshots is not None and self.snapshot_every
                and (step + 1) % self.snapshot_every == 0):
            t0 = time.perf_counter()
            # async managers: plan synchronously, persist in the background
            # — the round pays only the device probe (+ any backpressure)
            res = self.snapshots.snapshot(
                self.state, step=step,
                aux={"cursor": self.cursor.to_state(), "round": step},
                block=not getattr(self.snapshots, "is_async", False))
            snapshot_stall_ms = (time.perf_counter() - t0) * 1e3
            info = res if not isinstance(res, Future) \
                else self.snapshots.last_info
            if info is not None:
                snapshot_bytes = info.new_bytes
        if self.replicas is not None:
            # fan this round's writes to the peers off the hot path
            self.replicas.pump()

        # the per-round snapshot is pure registry deltas bracketing the
        # round — pump/read-repair/uplink all count through one mechanism
        after = self._stat_snapshot()
        d = self._delta
        stats = RoundStats(
            step=step, loss=float(np.mean(losses)),
            units=self.micro_batches,
            reissued=d(before, after, "sched", "reissued"),
            duplicates=d(before, after, "sched", "duplicates"),
            invalid=d(before, after, "sched", "invalid_results"),
            steals=d(before, after, "sched", "steals"),
            refills=d(before, after, "sched", "refills"),
            lease_expiries=d(before, after, "sched", "lease_expiries"),
            replicated=d(before, after, "replica", "sent"),
            read_repairs=d(before, after, "replica", "repaired"),
            uplink_dense=d(before, after, "trainer", "uplink_dense"),
            uplink_moved=d(before, after, "trainer", "uplink_moved"),
            uplink_dedup=d(before, after, "trainer", "uplink_dedup"),
            snapshot_stall_ms=snapshot_stall_ms,
            snapshot_bytes=snapshot_bytes,
        )
        self.history.append(stats)
        return stats

    def run(self, steps: int, start_step: int = 0) -> List[RoundStats]:
        return [self.round(s) for s in range(start_step, start_step + steps)]

    def dump_flight_recorder(self, path) -> int:
        """Write the telemetry hub's event ring to ``path`` as JSONL.

        Returns the number of events written (0 when tracing is off)."""
        return self.tel.dump_jsonl(path)

    # ---------------- crash recovery ----------------
    def restore_latest(self, abstract_state, *, device=None,
                       client_hashes: Optional[set] = None) -> int:
        """Restore state+cursor from the latest snapshot onto ``device``
        (by default the device the trainer's current state lies on, as the
        reference restores onto its default device); returns next step.
        ``abstract_state`` supplies the structure (e.g.
        ``api.state_specs(cfg)``).

        ``client_hashes``: refs this volunteer already holds.  When given,
        ``last_restore_plan`` records the block-level download accounting
        (``plan_send`` on the Wire) — only the delta objects written since
        it detached move.  With an ``edge`` tier attached the download
        routes through discovery and ``last_restore_plan['route']`` names
        the serving member."""
        if client_hashes is not None:
            if self.edge is not None:
                self.snapshots.wait()
                sid = self.snapshots.latest()
                if sid is None:
                    raise ValueError("no snapshots available")
                refs = self.snapshots.get_manifest(sid).all_refs()
                res = self.edge.fetch(refs, client_hashes)
                missing, moved, dedup = (res.missing, res.bytes_moved,
                                         res.bytes_dedup)
                route = res.route
            else:
                missing, moved, dedup = self.snapshots.download_plan(
                    client_hashes)
                route = "origin"
            self.last_restore_plan = {"missing": len(missing),
                                      "bytes_moved": moved,
                                      "bytes_dedup": dedup,
                                      "route": route}
        if device is None:
            device = tu.leaves(self.state)[0].device
        state, aux = self.snapshots.restore(target_tree=abstract_state,
                                            device=device)
        self.state = state
        self.cursor = Cursor.from_state(aux["cursor"])
        return int(aux["round"]) + 1
