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

The delta uplink, gradient compression, replica sets, edge caches and the
project server come with the port's uplink slice; asking for them raises.
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
from repro_torch.data.pipeline import Cursor, TokenStream


def grad_hash(tree) -> str:
    """blake2b over every leaf's bytes, in flatten order (host copies)."""
    h = hashlib.blake2b()
    for leaf in tu.leaves(tree):
        flat = leaf.detach().reshape(-1).view(torch.uint8)
        h.update(memoryview(flat.cpu().numpy()))
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
    counter field below is ``after - before`` of a scheduler counter
    bracketing the round.  The reference's replica and uplink fields come
    with those slices."""
    step: int
    loss: float
    units: int
    reissued: int
    duplicates: int
    invalid: int
    snapshot_bytes: int = 0
    snapshot_stall_ms: float = 0.0   # trainer-visible snapshot time only
    steals: int = 0              # work-steal batches this round
    refills: int = 0             # watermark refill batches this round
    lease_expiries: int = 0      # deadline-driven lease losses this round


def _not_ported(name: str) -> NotImplementedError:
    return NotImplementedError(f"{name} is not yet ported to repro_torch")


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
                 replicas=None, edge=None,
                 telemetry: Optional[tlm.Telemetry] = None):
        """grad_fn(params, batch)->(loss, grads); apply_fn(state, grads)->state.

        ``compress_grads``, ``server``/``project``/``uplink``, ``replicas``
        and ``edge`` are the reference's uplink, replication and edge
        paths; they raise until their slice is ported."""
        for name, on in (("compress_grads", compress_grads),
                         ("server/project", server is not None
                          or project is not None),
                         ("uplink", uplink), ("replicas", replicas is not None),
                         ("edge", edge is not None)):
            if on:
                raise _not_ported(name)
        self.grad_fn = grad_fn
        self.apply_fn = apply_fn
        self.state = state
        self.stream = stream
        self.micro_batches = micro_batches
        self.sched = scheduler or VolunteerScheduler(clock=SimClock())
        self.snapshots = snapshots
        self.snapshot_every = snapshot_every
        self.cursor = Cursor()
        self.coordinator = Coordinator()
        self.workers: Dict[str, SimWorker] = {}
        self._rng = np.random.default_rng(seed)
        self._grad_cache: Dict[str, tuple] = {}   # result_hash -> (loss, grads)
        self._completed: Dict[int, str] = {}      # drained, not yet consumed
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("trainer")
        self.tmetrics = scope.counters("folds")
        self.tstats = scope.view()
        self.last_restore_plan: Optional[dict] = None
        self.history: List[RoundStats] = []
        # elastic membership: called when the fleet empties — a real
        # volunteer project keeps receiving new volunteers
        self.respawn: Optional[Callable[["VolunteerTrainer"], None]] = None

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
        batch = self.stream.batch(unit.payload["batch_index"])
        loss, grads = self.grad_fn(self.state.params, batch)
        h = grad_hash(grads)
        if worker.rng.random() < worker.corrupt_prob:
            h = "corrupt-" + h[:16]        # wrong result; quorum rejects
        else:
            self._grad_cache[h] = (float(loss), grads)
        self.sched.report(worker.worker_id, unit.unit_id, h)

    # ---------------- one synchronous round ----------------
    def _stat_snapshot(self) -> Dict[str, dict]:
        """Registry counters RoundStats derives its per-round deltas from."""
        return {"sched": dict(self.sched.stats),
                "trainer": dict(self.tstats)}

    @staticmethod
    def _delta(before: Dict[str, dict], after: Dict[str, dict],
               group: str, key: str) -> int:
        return (after.get(group, {}).get(key, 0)
                - before.get(group, {}).get(key, 0))

    def round(self, step: int) -> RoundStats:
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
        self._completed.update(self.sched.drain_completed())
        round_units = sorted(uid for uid in self._completed
                             if uid // self.micro_batches == step)
        losses, grads = [], None
        for uid in round_units:
            loss, g = self._grad_cache[self._completed.pop(uid)]
            self.tmetrics.folds.inc()
            if self.tel.tracing:
                self.tel.event("fold", unit=uid, round=step)
            losses.append(loss)
            grads = g if grads is None else tu.tree_map(
                lambda a, b: a + b, grads, g)
        grads = tu.tree_map(lambda g: g / self.micro_batches, grads)
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
            snapshot_stall_ms=snapshot_stall_ms,
            snapshot_bytes=snapshot_bytes,
        )
        self.history.append(stats)
        return stats

    def run(self, steps: int, start_step: int = 0) -> List[RoundStats]:
        return [self.round(s) for s in range(start_step, start_step + steps)]

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
        it detached move."""
        if client_hashes is not None:
            missing, moved, dedup = self.snapshots.download_plan(
                client_hashes)
            self.last_restore_plan = {"missing": len(missing),
                                      "bytes_moved": moved,
                                      "bytes_dedup": dedup,
                                      "route": "origin"}
        if device is None:
            device = tu.leaves(self.state)[0].device
        state, aux = self.snapshots.restore(target_tree=abstract_state,
                                            device=device)
        self.state = state
        self.cursor = Cursor.from_state(aux["cursor"])
        return int(aux["round"]) + 1
