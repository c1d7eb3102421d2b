"""Volunteer work-unit scheduler (paper §II/§IV-C semantics).

BOINC's server distributes work units to untrusted, unreliable volunteers.
Production mechanics implemented here:

* leases with deadlines — a unit not reported by its deadline is re-issued;
* replication factor R + **quorum validation**: a unit is only accepted when
  ``quorum`` identical results arrive (results are hashes of deterministic
  computation, so agreement is bitwise — BOINC's validator);
* **exponential back-off**: a client whose request is rejected (server busy /
  no work) must wait 2^k * base seconds, protecting the server from request
  storms (paper §IV-C);
* **straggler mitigation**: when a unit's lease is mostly elapsed and spare
  capacity exists, a duplicate is dispatched and the first valid result wins
  — at most one duplicate per lease lifetime, so a slow unit cannot fan out
  to every requesting volunteer;
* **unsolicited-result rejection**: a result from a worker that never held a
  lease on the unit is dropped (``stats["unsolicited_results"]``) — a
  free-riding client cannot poison quorum with forged reports;
* elastic membership: workers join/leave at any time; deterministic work
  units (data/pipeline.py) mean any replacement volunteer reproduces the
  exact result.

The scheduler is pure bookkeeping (no jax): the elastic trainer drives it
with real train-step executions.  Three structures keep every hot operation
O(1) amortized regardless of how many units have ever been submitted, which
is what lets ``core/shardplane.py`` hold a million open units per shard:

* a pending deque that sheds completed units lazily (head fast-path, full
  rebuild only when more than half the entries are stale);
* a **deadline min-heap** of (expiry, unit, worker) lease entries, so
  expiry pops only the leases that are actually due instead of scanning
  every open unit per request (entries invalidated by a report/leave are
  skipped lazily);
* a per-worker lease index, so ``leave`` drops a volunteer's leases in
  O(its leases), not O(open units).

``tasks_per_day_capacity`` feeds the paper's 8.8 M-tasks/day
server-throughput comparison; ``benchmarks/server_throughput.py`` measures
the dispatch latency curve this buys.
"""
from __future__ import annotations

import heapq
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Set, Tuple

from repro_torch.core import telemetry as tlm


class SimClock:
    """Deterministic clock for simulation/tests (advanced by its caller)."""

    def __init__(self, t0: float = 0.0):
        self.t = t0

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


@dataclass
class WorkUnit:
    unit_id: int
    payload: dict                      # e.g. {"batch_index": i, "step": s}
    replication: int = 1
    quorum: int = 1
    deadline_s: float = 60.0
    max_extra_results: int = 4         # replica escalation cap (BOINC's
                                       # max_error_results analogue)
    # runtime bookkeeping
    results: Dict[str, str] = field(default_factory=dict)   # worker -> hash
    leases: Dict[str, float] = field(default_factory=dict)  # worker -> t0
    ever_leased: Set[str] = field(default_factory=set)      # lease history
    completed: bool = False
    canonical: Optional[str] = None    # winning result hash
    reissues: int = 0
    straggler_issued: bool = False     # duplicate sent this lease lifetime

    def quorum_met(self) -> bool:
        counts: Dict[str, int] = {}
        for h in self.results.values():
            counts[h] = counts.get(h, 0) + 1
        for h, c in counts.items():
            if c >= self.quorum:
                self.canonical = h
                return True
        return False


@dataclass
class WorkerInfo:
    worker_id: str
    joined: float
    backoff_until: float = 0.0
    backoff_k: int = 0
    credit: float = 0.0          # beyond-paper: the credit system V-BOINC defers
    completed: int = 0
    invalid: int = 0
    uplink_bytes: int = 0        # deduped bytes this worker actually moved
    uplink_dedup: int = 0        # bytes the server already held for it
    alive: bool = True


class VolunteerScheduler:
    def __init__(self, *, replication: int = 1, quorum: int = 1,
                 deadline_s: float = 60.0, backoff_base_s: float = 0.5,
                 backoff_max_s: float = 60.0, straggler_factor: float = 0.8,
                 max_extra_results: int = 4, clock=time.time,
                 telemetry: Optional[tlm.Telemetry] = None,
                 shard_id: Optional[int] = None):
        assert quorum <= replication
        self.replication = replication
        self.quorum = quorum
        self.max_extra_results = max_extra_results
        self.deadline_s = deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.straggler_factor = straggler_factor
        self.clock = clock
        self.units: Dict[int, WorkUnit] = {}
        # assignable/pending index: completed units leave this deque lazily —
        # the head is cleared on every dispatch, mid-deque stale entries are
        # swept only when they outnumber live ones (amortized O(1) per
        # completion instead of a full rebuild each time)
        self._open: deque[int] = deque()
        self._open_stale = 0           # completed units still in _open
        self._n_open = 0               # exact open count (done() is O(1))
        # deadline min-heap: (expiry, unit_id, worker, lease_t0); entries
        # whose lease was already reported/dropped are skipped on pop
        self._lease_heap: List[Tuple[float, int, str, float]] = []
        # worker -> {unit_id: lease_t0}: mirrors WorkUnit.leases so leave()
        # drops exactly this worker's leases without touching other units
        self._worker_leases: Dict[str, Dict[int, float]] = {}
        # incremental completion view: (unit_id, canonical hash) appended
        # as quorums are met, drained by the trainer each round — the
        # uplink analogue of the pending index (no O(all units) scans)
        self._completed_log: List[tuple[int, str]] = []
        self.workers: Dict[str, WorkerInfo] = {}
        # telemetry: typed counters behind the historical dict shape —
        # .stats stays a (read-only) mapping with the same keys, writes
        # go through .metrics so the registry is the single source
        self.tel = tlm.resolve(telemetry)
        self.shard_id = shard_id
        scope = self.tel.scope("scheduler")
        self.metrics = scope.counters(
            "dispatched", "completed", "reissued", "duplicates",
            "rejected_requests", "invalid_results", "dropped_leases",
            "unsolicited_results", "quorum_batches", "lease_expiries")
        self.stats = scope.view()
        self._dispatch_hist = scope.histogram("dispatch_latency_s",
                                              tlm.TIME_BUCKETS_S)

    # ---------------- membership (elastic) ----------------
    def join(self, worker_id: str) -> WorkerInfo:
        info = self.workers.get(worker_id)
        if info is None:
            info = WorkerInfo(worker_id, self.clock())
            self.workers[worker_id] = info
        elif not info.alive:
            # revive in place: a volunteer that left and came back keeps
            # its credit/completed/invalid/uplink ledger (replacing the
            # record wiped the counters, so every leave→rejoin cycle —
            # and the shard-failover merge that joins a worker on its new
            # home — destroyed minted credit)
            info.alive = True
            info.joined = self.clock()
            info.backoff_until = 0.0
            info.backoff_k = 0
        return info

    def leave(self, worker_id: str) -> None:
        info = self.workers.get(worker_id)
        if info is not None:
            info.alive = False
        tel = self.tel
        lseq = tel.event("worker_leave", worker=worker_id,
                         shard=self.shard_id) if tel.tracing else 0
        # drop leases so units re-issue immediately — O(this worker's
        # leases) via the per-worker index, not O(open units)
        for uid, t0 in self._worker_leases.pop(worker_id, {}).items():
            wu = self.units.get(uid)
            if (wu is not None and not wu.completed
                    and wu.leases.get(worker_id) == t0):
                del wu.leases[worker_id]
                wu.straggler_issued = False   # lease lifetime ended
                self.metrics.dropped_leases.inc()
                if tel.tracing:
                    tel.event("lease_drop", unit=uid, worker=worker_id,
                              shard=self.shard_id, cause="worker_leave",
                              cause_seq=lseq)

    # ---------------- unit lifecycle ----------------
    def submit(self, unit_id: int, payload: dict, *,
               replication: Optional[int] = None,
               quorum: Optional[int] = None) -> WorkUnit:
        # explicit values are honored even when falsy — only None falls
        # back to the scheduler default (a submit(quorum=0) used to be
        # silently replaced by the default, masking the misconfiguration)
        rep = self.replication if replication is None else replication
        quo = self.quorum if quorum is None else quorum
        if rep < 1 or quo < 1:
            raise ValueError(f"replication/quorum must be >= 1 "
                             f"(got replication={rep}, quorum={quo})")
        if quo > rep:
            raise ValueError(f"quorum {quo} > replication {rep}")
        wu = WorkUnit(unit_id, payload, replication=rep, quorum=quo,
                      deadline_s=self.deadline_s,
                      max_extra_results=self.max_extra_results)
        prev = self.units.get(unit_id)
        if prev is not None and prev.completed:
            # the stale completed entry for this id would alias the new
            # unit — rebuild the index before re-adding
            self._rebuild_open()
        elif prev is not None:
            # replacing a still-open unit: its entry is reused; detach the
            # old leases so the mirror stays exact (heap entries go stale
            # and are skipped on pop)
            for w in prev.leases:
                self._worker_leases.get(w, {}).pop(unit_id, None)
        self.units[unit_id] = wu
        if prev is None or prev.completed:
            self._open.append(unit_id)
            self._n_open += 1
        if self.tel.tracing:
            self.tel.event("submit", unit=unit_id, shard=self.shard_id,
                           replication=rep, quorum=quo)
        return wu

    def _rebuild_open(self) -> None:
        self._open = deque(uid for uid in self._open
                           if not self.units[uid].completed)
        self._open_stale = 0

    def _prune_open(self) -> None:
        # amortized: rebuild only when stale entries dominate
        if self._open_stale * 2 > len(self._open):
            self._rebuild_open()

    def _assignable(self, wu: WorkUnit, worker_id: str, now: float) -> bool:
        if wu.completed or worker_id in wu.results or worker_id in wu.leases:
            return False
        active = len(wu.leases) + len(wu.results)
        if active < wu.replication:
            return True
        # replica escalation: validation inconclusive (e.g. a corrupt result
        # broke the quorum) and nobody is working on it -> issue another copy
        if (not wu.leases and not wu.quorum_met()
                and len(wu.results) < wu.replication + wu.max_extra_results):
            return True
        # straggler duplicate: lease mostly elapsed, no result yet — at most
        # one duplicate per lease lifetime (the flag clears when a lease
        # expires or is dropped, i.e. when a new lifetime starts)
        if not wu.results and wu.leases and not wu.straggler_issued:
            oldest = min(wu.leases.values())
            if now - oldest > self.straggler_factor * wu.deadline_s:
                return True
        return False

    def _grant(self, wu: WorkUnit, worker_id: str, now: float) -> None:
        active = len(wu.leases) + len(wu.results)
        dup = bool(wu.leases) or bool(wu.results)
        straggler = (active >= wu.replication and not wu.results
                     and bool(wu.leases))
        wu.leases[worker_id] = now
        wu.ever_leased.add(worker_id)
        self._worker_leases.setdefault(worker_id, {})[wu.unit_id] = now
        heapq.heappush(self._lease_heap,
                       (now + wu.deadline_s, wu.unit_id, worker_id, now))
        if straggler:
            wu.straggler_issued = True
        self.metrics.dispatched.inc()
        if dup and len(wu.leases) + len(wu.results) > wu.replication:
            self.metrics.duplicates.inc()
        tel = self.tel
        if tel.tracing:
            tel.event("dispatch", unit=wu.unit_id, worker=worker_id,
                      shard=self.shard_id, dup=dup)
            tel.event("lease", unit=wu.unit_id, worker=worker_id,
                      shard=self.shard_id, deadline=now + wu.deadline_s)

    def _dispatch(self, worker_id: str, now: float) -> Optional[WorkUnit]:
        while self._open and self.units[self._open[0]].completed:
            self._open.popleft()           # head fast-path prune
            self._open_stale -= 1
        for uid in self._open:             # submit order, open units only
            wu = self.units[uid]
            if wu.completed:
                continue
            if self._assignable(wu, worker_id, now):
                self._grant(wu, worker_id, now)
                return wu
        return None

    def in_backoff(self, worker_id: str, now: Optional[float] = None) -> bool:
        info = self.workers.get(worker_id)
        if info is None:
            return False
        return (now if now is not None else self.clock()) < info.backoff_until

    def backoff(self, worker_id: str, now: Optional[float] = None) -> float:
        """Apply one exponential back-off step (paper §IV-C); -> delay."""
        info = self.join(worker_id)
        now = self.clock() if now is None else now
        info.backoff_k = min(info.backoff_k + 1, 12)
        delay = min(self.backoff_base_s * (2 ** info.backoff_k),
                    self.backoff_max_s)
        info.backoff_until = now + delay
        self.metrics.rejected_requests.inc()
        return delay

    def request_work(self, worker_id: str) -> Optional[WorkUnit]:
        """A volunteer asks for work (may be told to back off)."""
        if not self.tel.tracing:
            return self._request_work(worker_id)
        t0 = time.perf_counter()
        wu = self._request_work(worker_id)
        self._dispatch_hist.observe(time.perf_counter() - t0)
        return wu

    def _request_work(self, worker_id: str) -> Optional[WorkUnit]:
        now = self.clock()
        info = self.join(worker_id)
        if now < info.backoff_until:
            self.metrics.rejected_requests.inc()
            return None
        self._expire_leases(now)
        wu = self._dispatch(worker_id, now)
        if wu is not None:
            info.backoff_k = 0          # ONLY successful dispatch resets
            info.backoff_until = 0.0
            return wu
        self.backoff(worker_id, now)
        return None

    def request_batch(self, worker_id: str, max_units: int,
                      tail: bool = False) -> List[WorkUnit]:
        """Lease up to ``max_units`` assignable units in one index scan.

        The shard plane's watermark refill: one scan amortizes the cost of
        skipping a leased prefix over the whole batch.  ``tail=True`` scans
        newest-first — the work-stealing direction (steal from the tail of
        the victim's backlog, pytest-xdist style), so thieves and the
        owner's own refills collide as little as possible.  Does NOT apply
        back-off on an empty result: the caller (plane) decides after all
        refill sources are exhausted."""
        now = self.clock()
        info = self.join(worker_id)
        if now < info.backoff_until:
            self.metrics.rejected_requests.inc()
            return []
        self._expire_leases(now)
        got: List[WorkUnit] = []
        while self._open and self.units[self._open[0]].completed:
            self._open.popleft()
            self._open_stale -= 1
        it = reversed(self._open) if tail else iter(self._open)
        for uid in it:
            if len(got) >= max_units:
                break
            wu = self.units[uid]
            if wu.completed:
                continue
            if self._assignable(wu, worker_id, now):
                self._grant(wu, worker_id, now)
                got.append(wu)
        if got:
            info.backoff_k = 0
            info.backoff_until = 0.0
        return got

    # ---------------- results / validation ----------------
    def _accept_result(self, worker_id: str, unit_id: int,
                       result_hash: str) -> Optional[WorkUnit]:
        """Record one result; -> the unit if recorded, None if rejected."""
        wu = self.units.get(unit_id)
        if wu is None or wu.completed:
            return None
        if worker_id not in wu.ever_leased:
            # forged/free-riding report: this worker never held a lease on
            # the unit, so its "result" must not count toward quorum
            self.metrics.unsolicited_results.inc()
            if self.tel.tracing:
                self.tel.event("report_rejected", unit=unit_id,
                               worker=worker_id, shard=self.shard_id,
                               cause="unsolicited")
            return None
        if wu.leases.pop(worker_id, None) is not None:
            self._worker_leases.get(worker_id, {}).pop(unit_id, None)
        wu.results[worker_id] = result_hash
        if self.tel.tracing:
            self.tel.event("report", unit=unit_id, worker=worker_id,
                           shard=self.shard_id, result=result_hash[:16])
        return wu

    def _complete(self, wu: WorkUnit) -> None:
        """Quorum met: mint credit, retire the unit from the open index."""
        wu.completed = True
        self._n_open -= 1
        self._open_stale += 1
        self._prune_open()
        self._completed_log.append((wu.unit_id, wu.canonical))
        self.metrics.completed.inc()
        if self.tel.tracing:
            self.tel.event("quorum", unit=wu.unit_id, shard=self.shard_id,
                           canonical=wu.canonical[:16],
                           results=len(wu.results))
        n_canon = sum(1 for x in wu.results.values() if x == wu.canonical)
        for wid, h in wu.results.items():
            info = self.workers.get(wid)
            if info is None:
                continue
            if h == wu.canonical:
                info.completed += 1
                info.credit += 1.0 / max(1, n_canon)
            else:
                info.invalid += 1
                self.metrics.invalid_results.inc()
        # remaining leases are moot; clear them so the mirror stays exact
        for wid in wu.leases:
            self._worker_leases.get(wid, {}).pop(wu.unit_id, None)
        wu.leases.clear()

    def report(self, worker_id: str, unit_id: int, result_hash: str) -> bool:
        """Validator path: accept when ``quorum`` identical hashes exist."""
        wu = self._accept_result(worker_id, unit_id, result_hash)
        if wu is None:
            return False
        if wu.quorum_met():
            self._complete(wu)
            return True
        return False

    def report_batch(self, reports: Iterable[Tuple[str, int, str]]
                     ) -> List[tuple[int, str]]:
        """Apply a batch of (worker, unit, hash) results, then validate
        quorum once per touched unit instead of once per result — the
        per-round validation model the shard plane uses.  Results that
        arrive in the same batch as the quorum-completing one still count
        (credit splits over every canonical result in the batch); the
        conservation invariant — total completion credit == completed
        units — is unchanged.  -> newly completed (unit_id, canonical)."""
        touched: Dict[int, WorkUnit] = {}
        for worker_id, unit_id, result_hash in reports:
            wu = self._accept_result(worker_id, unit_id, result_hash)
            if wu is not None:
                touched[unit_id] = wu
        self.metrics.quorum_batches.inc()
        done: List[tuple[int, str]] = []
        for unit_id, wu in touched.items():
            if not wu.completed and wu.quorum_met():
                self._complete(wu)
                done.append((unit_id, wu.canonical))
        return done

    def _expire_leases(self, now: float) -> None:
        """Pop due leases off the deadline heap — O(expired), not O(open).

        A single large clock jump (SimClock advance) expires every due
        lease in one call; entries whose lease was already reported,
        dropped or superseded are skipped by the t0 check."""
        h = self._lease_heap
        while h and h[0][0] <= now:
            _, uid, worker_id, t0 = heapq.heappop(h)
            wu = self.units.get(uid)
            if (wu is None or wu.completed
                    or wu.leases.get(worker_id) != t0):
                continue                   # stale heap entry
            del wu.leases[worker_id]
            self._worker_leases.get(worker_id, {}).pop(uid, None)
            wu.reissues += 1
            wu.straggler_issued = False    # new lease lifetime begins
            self.metrics.lease_expiries.inc()
            self.metrics.reissued.inc()
            tel = self.tel
            if tel.tracing:
                eseq = tel.event("lease_expire", unit=uid,
                                 worker=worker_id, shard=self.shard_id)
                tel.event("reissue", unit=uid, worker=worker_id,
                          shard=self.shard_id, cause="lease_expire",
                          cause_seq=eseq)

    # ---------------- progress ----------------
    def open_backlog(self) -> int:
        """Exact count of not-yet-completed units — O(1)."""
        return self._n_open

    def pending(self) -> List[WorkUnit]:
        self._rebuild_open()
        return [self.units[uid] for uid in self._open]

    def done(self) -> bool:
        return self._n_open == 0

    def drain_completed(self) -> List[tuple[int, str]]:
        """(unit_id, canonical hash) pairs completed since the last drain.

        O(newly completed), unlike ``canonical_results()``'s scan of every
        unit ever submitted — the trainer's per-round result view."""
        out, self._completed_log = self._completed_log, []
        return out

    def credit_transfer(self, worker_id: str, moved_bytes: int,
                        dedup_bytes: int = 0) -> None:
        """Uplink credit: BOINC grants credit for work *delivered*; here a
        volunteer earns by the deduped bytes it actually moved (bytes the
        server already held cost it nothing and earn nothing)."""
        info = self.workers.get(worker_id)
        if info is None:
            return
        info.uplink_bytes += moved_bytes
        info.uplink_dedup += dedup_bytes
        info.credit += moved_bytes / float(1 << 20)   # 1 credit per MiB

    def canonical_results(self) -> Dict[int, str]:
        return {uid: u.canonical for uid, u in self.units.items()
                if u.completed}
