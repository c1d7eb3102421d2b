"""Sharded million-volunteer scheduler plane.

The paper's server is ONE machine; BOINC already pushes such a machine to
~8.8 M tasks/day, and V-BOINC predicts the server becomes the bottleneck
once capsule transfer is layered on.  ``ShardedScheduler`` splits the
control plane across N independent ``VolunteerScheduler`` shards while
presenting the exact ``request_work``/``report``/``drain_completed``
interface ``VBoincServer`` and ``VolunteerTrainer`` already speak.

Data flow — key range → shard → watermark queue:

1. **Key-range partitioning.**  The plane owns ``4*N`` contiguous
   *range slots*.  A volunteer's sha256 account-key hash picks its slot;
   ``_range_owner[slot]`` maps the slot to the shard that serves it (the
   indirection is what makes failover a table edit, not a re-hash of the
   fleet).  Work units stripe over the same slots by unit id, so each
   shard owns a disjoint set of units and volunteers mostly talk to one
   shard.
2. **Watermark refill (pytest-xdist ``LoadScheduling`` model).**  Each
   volunteer has a small local pending queue.  ``request_work`` pops from
   it in O(1); when the queue drops below ``watermark`` the plane refills
   a batch of ``refill_batch`` leases from the volunteer's home shard in
   ONE index scan — the scan cost amortizes over the batch, which is what
   keeps dispatch latency flat at millions of open units.
3. **Work stealing.**  A volunteer whose home shard is dry steals a batch
   from the *tail* of the largest open backlog among the other alive
   shards (newest units first, so thieves collide least with the owner's
   own head-first refills).  Only when every shard is dry does the
   volunteer get the home shard's exponential back-off.
4. **Batched quorum.**  ``report`` buffers results; ``flush_reports`` —
   called at most once per trainer round (from ``done``/``pending``/
   ``drain_completed``) or when the buffer hits ``report_batch_max`` —
   groups them by shard and validates quorum once per touched unit
   (``VolunteerScheduler.report_batch``) instead of once per result.
5. **Shard failover.**  ``fail_shard(i)`` (driven by the seeded
   ``ChurnSim``) deterministically reassigns the dead shard's range slots
   to the survivors, migrates its open units (results and lease history
   travel; leases drop and re-issue), merges its per-worker credit into
   each worker's new home shard, and preserves its completed log — no
   unit is lost, double-credited, or over-replicated across the move.
   ``tests/test_shardplane.py`` proves this differentially against a
   single-scheduler oracle under thousands of random interleavings.
6. **Elastic membership.**  Shard count grows and shrinks with demand
   (Anderson 2018's elastic control plane), all built on one reusable
   slot-handoff primitive, ``_migrate_slots(slots, target)`` — the
   generalized body of ``fail_shard``'s migration: slot ownership is a
   table edit, open units move with results + lease history intact
   (live leases drop, are counted, and re-issue on the target), and
   per-worker ledgers settle onto the new home so total minted credit
   is conserved through any join/split/kill/rejoin schedule.

   * ``add_shard()`` — a new ``VolunteerScheduler`` joins the plane and
     takes a fair share of slots from the currently most-loaded owners;
   * ``split_shard(i)`` — a hot shard hands off half of its slots
     (greedy backlog halving) to the least-loaded peer;
   * ``rejoin_shard(i)`` — a killed shard returns empty and earns its
     share of slots back through the same take-from-the-loaded path;
   * slot placement everywhere (including failover) is backlog-aware
     greedy bin packing, replacing the old ``slot % survivors``
     round-robin, and the steal policy picks its victim by per-shard
     *request rate* (demand tracked in the telemetry scope per refill
     window) relative to backlog — an oversupplied shard with no live
     requesters is robbed before a busy one with a deep queue.

   Every handoff traces ``slot_handoff``/``shard_join`` events stamped
   with ``cause=``/``cause_seq=`` at the source, and the randomized
   oracle-differential harness drives full join/split/kill/rejoin
   schedules byte-identically against the single-scheduler oracle.
"""
from __future__ import annotations

import hashlib
import time
from collections import deque
from typing import Deque, Dict, Iterator, List, Optional, Tuple

from repro_torch.core import telemetry as tlm
from repro_torch.core.scheduler import (SimClock, VolunteerScheduler, WorkerInfo,
                                  WorkUnit)

SLOTS_PER_SHARD = 4      # range slots per shard: granularity of failover


def key_hash(worker_id: str) -> int:
    """Stable account-key hash (sha256, like the server's account keys —
    NOT Python's salted hash())."""
    return int.from_bytes(
        hashlib.sha256(worker_id.encode()).digest()[:8], "big")


class _UnitsView:
    """Read-only mapping over every shard's units, routed by the plane's
    unit→shard index — lets trainer/server code written against
    ``scheduler.units`` run unchanged."""

    def __init__(self, plane: "ShardedScheduler"):
        self._plane = plane

    def get(self, unit_id: int, default=None) -> Optional[WorkUnit]:
        sidx = self._plane._unit_shard.get(unit_id)
        if sidx is None:
            return default
        return self._plane.shards[sidx].units.get(unit_id, default)

    def __getitem__(self, unit_id: int) -> WorkUnit:
        wu = self.get(unit_id)
        if wu is None:
            raise KeyError(unit_id)
        return wu

    def __contains__(self, unit_id: int) -> bool:
        return self.get(unit_id) is not None

    def __len__(self) -> int:
        return sum(len(s.units) for s in self._plane.shards)

    def __iter__(self) -> Iterator[int]:
        for s in self._plane.shards:
            yield from s.units

    def items(self):
        for s in self._plane.shards:
            yield from s.units.items()

    def values(self):
        for s in self._plane.shards:
            yield from s.units.values()


class ShardedScheduler:
    """N ``VolunteerScheduler`` shards behind the single-scheduler API."""

    def __init__(self, *, shards: int = 4, replication: int = 1,
                 quorum: int = 1, deadline_s: float = 60.0,
                 backoff_base_s: float = 0.5, backoff_max_s: float = 60.0,
                 straggler_factor: float = 0.8, max_extra_results: int = 4,
                 clock=time.time, watermark: int = 2, refill_batch: int = 8,
                 steal: bool = True, report_batch_max: int = 1024,
                 telemetry: Optional[tlm.Telemetry] = None):
        if shards < 1:
            raise ValueError("need at least one shard")
        self.tel = tlm.resolve(telemetry)
        self.n_shards = shards
        self.replication = replication
        self.quorum = quorum
        self.deadline_s = deadline_s
        self.backoff_base_s = backoff_base_s
        self.backoff_max_s = backoff_max_s
        self.straggler_factor = straggler_factor
        self.max_extra_results = max_extra_results
        self.clock = clock
        self.watermark = watermark
        self.refill_batch = max(refill_batch, 1)
        self.steal = steal
        self.report_batch_max = report_batch_max
        self.shards = [self._new_shard(i) for i in range(shards)]
        self.n_slots = SLOTS_PER_SHARD * shards
        # range slot -> owning shard; failover rewrites entries in place
        self._range_owner: List[int] = [i % shards
                                        for i in range(self.n_slots)]
        self.shard_alive: List[bool] = [True] * shards
        self._unit_shard: Dict[int, int] = {}      # unit -> current shard
        self._home_cache: Dict[str, int] = {}      # worker -> slot
        # per-volunteer low-watermark pending queue: (shard_idx, unit_id)
        self._queues: Dict[str, Deque[Tuple[int, int]]] = {}
        # buffered (worker, unit, hash) reports awaiting the round flush
        self._report_buf: List[Tuple[str, int, str]] = []
        # completion log preserved across shard failover migrations
        self._migrated_completed: List[tuple[int, str]] = []
        self.units = _UnitsView(self)
        scope = self.tel.scope("shardplane")
        self._scope = scope
        self.metrics = scope.counters(
            "refills", "refill_units", "steals", "steal_units",
            "shard_kills", "shard_joins", "shard_splits", "slot_handoffs",
            "migrated_units", "report_flushes")
        self.plane_stats = scope.view()
        self._flush_hist = scope.histogram("report_flush_size",
                                           tlm.SIZE_BUCKETS)
        self._dispatch_hist = scope.histogram("dispatch_latency_s",
                                              tlm.TIME_BUCKETS_S)
        # per-shard demand signal for the steal policy: home-routed
        # request counts live in the telemetry scope; the mark snapshots
        # each counter at the last report flush, so (value - mark) is the
        # request rate over the current refill window
        self._shard_req = [scope.counter(f"requests_shard{i}")
                           for i in range(shards)]
        self._req_mark = [0] * shards

    def _new_shard(self, index: int) -> VolunteerScheduler:
        return VolunteerScheduler(
            replication=self.replication, quorum=self.quorum,
            deadline_s=self.deadline_s, backoff_base_s=self.backoff_base_s,
            backoff_max_s=self.backoff_max_s,
            straggler_factor=self.straggler_factor,
            max_extra_results=self.max_extra_results, clock=self.clock,
            telemetry=self.tel, shard_id=index)

    # ---------------- key-range routing ----------------
    def slot_of(self, worker_id: str) -> int:
        slot = self._home_cache.get(worker_id)
        if slot is None:
            slot = key_hash(worker_id) % self.n_slots
            self._home_cache[worker_id] = slot
        return slot

    def home_shard(self, worker_id: str) -> int:
        return self._range_owner[self.slot_of(worker_id)]

    def unit_slot(self, unit_id: int) -> int:
        return unit_id % self.n_slots

    # ---------------- membership (elastic) ----------------
    def join(self, worker_id: str) -> WorkerInfo:
        return self.shards[self.home_shard(worker_id)].join(worker_id)

    def leave(self, worker_id: str) -> None:
        # the worker may hold leases on foreign shards (stealing): drop
        # them everywhere it has state
        for s in self.shards:
            if worker_id in s.workers or worker_id in s._worker_leases:
                s.leave(worker_id)
        self._queues.pop(worker_id, None)

    # ---------------- unit lifecycle ----------------
    def submit(self, unit_id: int, payload: dict, *,
               replication: Optional[int] = None,
               quorum: Optional[int] = None) -> WorkUnit:
        prev = self._unit_shard.get(unit_id)
        sidx = self._range_owner[self.unit_slot(unit_id)]
        if prev is not None and prev != sidx:
            wu_prev = self.shards[prev].units.get(unit_id)
            if wu_prev is not None and not wu_prev.completed:
                # resubmit of a unit that migrated to a non-home shard:
                # keep it where it lives so the open entry is reused
                sidx = prev
        self._unit_shard[unit_id] = sidx
        return self.shards[sidx].submit(unit_id, payload,
                                        replication=replication,
                                        quorum=quorum)

    # ---------------- dispatch: watermark queue + stealing -------------
    def _valid_entry(self, worker_id: str, sidx: int, unit_id: int) -> bool:
        # a queued lease may have expired/migrated/completed since refill
        if self._unit_shard.get(unit_id) != sidx:
            return False
        wu = self.shards[sidx].units.get(unit_id)
        return (wu is not None and not wu.completed
                and worker_id in wu.leases)

    def _refill(self, worker_id: str, q: Deque[Tuple[int, int]],
                now: float) -> None:
        # size the refill from *valid* queue entries only: after churn
        # (expiry, migration, completion) the queue holds entries that
        # `_valid_entry` will discard on pop, and counting them made
        # every post-churn refill chronically short
        if q:
            live = [e for e in q if self._valid_entry(worker_id, *e)]
            if len(live) != len(q):
                q.clear()
                q.extend(live)
        want = self.watermark + self.refill_batch - len(q)
        if want <= 0:
            return
        home = self.home_shard(worker_id)
        got = self.shards[home].request_batch(worker_id, want)
        if got:
            self.metrics.refills.inc()
            self.metrics.refill_units.inc(len(got))
            if self.tel.tracing:
                self.tel.event("refill", worker=worker_id, shard=home,
                               n=len(got))
            q.extend((home, wu.unit_id) for wu in got)
            return
        if not self.steal:
            return
        victim = self._steal_victim(home)
        if victim < 0:
            return
        got = self.shards[victim].request_batch(worker_id, want, tail=True)
        if got:
            self.metrics.steals.inc()
            self.metrics.steal_units.inc(len(got))
            if self.tel.tracing:
                self.tel.event("steal", worker=worker_id, shard=victim,
                               n=len(got), home=home)
            q.extend((victim, wu.unit_id) for wu in got)

    def _steal_victim(self, home: int) -> int:
        """Pick the shard to steal from: highest open backlog *per unit
        of demand* (home-routed requests since the last report flush),
        not raw backlog size.  An oversupplied shard whose volunteers
        went quiet is robbed before a busy shard whose deep queue is
        already being drained by its own population.  Deterministic:
        ties break by raw backlog, then lowest index."""
        victim, best = -1, None
        for i, s in enumerate(self.shards):
            if i == home or not self.shard_alive[i]:
                continue
            backlog = s.open_backlog()
            if backlog <= 0:
                continue
            rate = self._shard_req[i].value - self._req_mark[i]
            key = (backlog / (1.0 + rate), backlog, -i)
            if best is None or key > best:
                victim, best = i, key
        return victim

    def request_work(self, worker_id: str) -> Optional[WorkUnit]:
        """O(1) pop from the volunteer's watermark queue; batch refill
        (then steal) only when the queue runs low."""
        if not self.tel.tracing:
            return self._request_work(worker_id)
        t0 = time.perf_counter()
        wu = self._request_work(worker_id)
        self._dispatch_hist.observe(time.perf_counter() - t0)
        return wu

    def _request_work(self, worker_id: str) -> Optional[WorkUnit]:
        now = self.clock()
        home_idx = self.home_shard(worker_id)
        self._shard_req[home_idx].inc()    # demand signal for stealing
        home = self.shards[home_idx]
        info = home.join(worker_id)
        if now < info.backoff_until:
            home.metrics.rejected_requests.inc()
            return None
        q = self._queues.setdefault(worker_id, deque())
        refilled = len(q) < self.watermark
        if refilled:
            self._refill(worker_id, q, now)
        while q:
            sidx, unit_id = q.popleft()
            if self._valid_entry(worker_id, sidx, unit_id):
                return self.shards[sidx].units[unit_id]
        if not refilled:
            # the queue *looked* stocked but churn (expiry, migration,
            # completion) had invalidated every entry — refill now, at
            # full size, instead of bouncing the volunteer into backoff
            self._refill(worker_id, q, now)
            while q:
                sidx, unit_id = q.popleft()
                if self._valid_entry(worker_id, sidx, unit_id):
                    return self.shards[sidx].units[unit_id]
        # every refill source is dry: exponential back-off on the home
        # shard (only a successful dispatch resets it)
        home.backoff(worker_id, now)
        return None

    # ---------------- results: per-round batched quorum ----------------
    def report(self, worker_id: str, unit_id: int, result_hash: str) -> bool:
        """Buffer the result; quorum validates at the next round flush.

        -> True only when this call's flush completed the unit (callers
        needing completion should watch ``drain_completed``, as the
        trainer already does)."""
        self._report_buf.append((worker_id, unit_id, result_hash))
        if len(self._report_buf) >= self.report_batch_max:
            done = self.flush_reports()
            return any(uid == unit_id for uid, _ in done)
        return False

    def flush_reports(self) -> List[tuple[int, str]]:
        """Apply buffered results grouped by shard, one quorum check per
        touched unit per shard (``report_batch``)."""
        if not self._report_buf:
            return []
        buf, self._report_buf = self._report_buf, []
        by_shard: Dict[int, List[Tuple[str, int, str]]] = {}
        for worker_id, unit_id, h in buf:
            sidx = self._unit_shard.get(unit_id)
            if sidx is None:
                continue               # unknown unit: drop silently
            by_shard.setdefault(sidx, []).append((worker_id, unit_id, h))
        done: List[tuple[int, str]] = []
        for sidx, reports in by_shard.items():
            done.extend(self.shards[sidx].report_batch(reports))
        self.metrics.report_flushes.inc()
        self._flush_hist.observe(len(buf))
        # roll the request-rate window: (counter - mark) measures demand
        # since the last flush, the steal policy's denominator
        for i, c in enumerate(self._shard_req):
            self._req_mark[i] = c.value
        return done

    # ---------------- progress ----------------
    def open_backlog(self) -> int:
        return sum(s.open_backlog() for s in self.shards)

    def done(self) -> bool:
        self.flush_reports()
        return self.open_backlog() == 0

    def pending(self) -> List[WorkUnit]:
        self.flush_reports()
        out: List[WorkUnit] = []
        for s in self.shards:
            out.extend(s.pending())
        return out

    def drain_completed(self) -> List[tuple[int, str]]:
        self.flush_reports()
        out = self._migrated_completed
        self._migrated_completed = []
        for s in self.shards:
            out.extend(s.drain_completed())
        return out

    def canonical_results(self) -> Dict[int, str]:
        out: Dict[int, str] = {}
        for s in self.shards:
            out.update(s.canonical_results())
        return out

    def _expire_leases(self, now: float) -> None:
        for i, s in enumerate(self.shards):
            if self.shard_alive[i]:
                s._expire_leases(now)

    # ---------------- credit ----------------
    def credit_transfer(self, worker_id: str, moved_bytes: int,
                        dedup_bytes: int = 0) -> None:
        self.shards[self.home_shard(worker_id)].credit_transfer(
            worker_id, moved_bytes, dedup_bytes)

    @property
    def workers(self) -> Dict[str, WorkerInfo]:
        """Merged per-worker view (a worker that stole work has state on
        several shards); credit/counters sum, alive ORs."""
        merged: Dict[str, WorkerInfo] = {}
        for s in self.shards:
            for wid, info in s.workers.items():
                m = merged.get(wid)
                if m is None:
                    merged[wid] = m = WorkerInfo(wid, info.joined)
                    m.alive = False
                m.credit += info.credit
                m.completed += info.completed
                m.invalid += info.invalid
                m.uplink_bytes += info.uplink_bytes
                m.uplink_dedup += info.uplink_dedup
                m.alive = m.alive or info.alive
                m.backoff_until = max(m.backoff_until, info.backoff_until)
        return merged

    @property
    def stats(self) -> Dict[str, int]:
        agg: Dict[str, int] = {}
        for s in self.shards:
            for k, v in s.stats.items():
                agg[k] = agg.get(k, 0) + v
        agg.update(self.plane_stats)
        agg["shards"] = self.n_shards
        agg["shards_alive"] = sum(self.shard_alive)
        return agg

    # ---------------- elastic membership: slot handoff ----------------
    def alive_shards(self) -> List[int]:
        return [i for i, a in enumerate(self.shard_alive) if a]

    def _slot_backlog(self) -> Dict[int, int]:
        """Open-unit count per range slot (the placement weight)."""
        out: Dict[int, int] = {}
        for s in self.shards:
            for uid, wu in s.units.items():
                if not wu.completed:
                    slot = self.unit_slot(uid)
                    out[slot] = out.get(slot, 0) + 1
        return out

    def _place_slots(self, slots: List[int],
                     candidates: List[int]) -> Dict[int, List[int]]:
        """Backlog-aware slot placement (replaces ``slot % survivors``):
        greedy bin packing — heaviest slot first, each to the candidate
        with the smallest projected backlog.  Fully deterministic (ties
        break by slot, then candidate index)."""
        slot_load = self._slot_backlog()
        load = {c: float(self.shards[c].open_backlog()) for c in candidates}
        placement: Dict[int, List[int]] = {c: [] for c in candidates}
        for slot in sorted(slots, key=lambda s: (-slot_load.get(s, 0), s)):
            tgt = min(candidates, key=lambda c: (load[c], c))
            placement[tgt].append(slot)
            load[tgt] += slot_load.get(slot, 0)
        return placement

    def _move_unit(self, unit_id: int, wu: WorkUnit,
                   src: VolunteerScheduler, src_idx: int, target_idx: int,
                   totals: Dict[str, int], *, cause: str,
                   cause_seq: int) -> None:
        """Move one unit to ``target_idx``: results + lease history +
        escalation counters travel; live leases drop (counted, traced
        with their cause) and re-issue on the target; every worker in
        the lease history gets a ledger slot there so a late report from
        a pre-move lease holder still settles its credit."""
        tel = self.tel
        target = self.shards[target_idx]
        self._unit_shard[unit_id] = target_idx
        if wu.completed:
            target.units[unit_id] = wu
            totals["copied_completed"] += 1
            return
        totals["dropped_leases"] += len(wu.leases)
        src.metrics.dropped_leases.inc(len(wu.leases))
        for wid in wu.leases:
            src._worker_leases.get(wid, {}).pop(unit_id, None)
            if tel.tracing:
                tel.event("lease_drop", unit=unit_id, worker=wid,
                          shard=src_idx, cause=cause, cause_seq=cause_seq)
        wu.leases.clear()              # heap/mirror entries go stale
        wu.straggler_issued = False
        target.units[unit_id] = wu
        target._open.append(unit_id)
        target._n_open += 1
        totals["reassigned_open"] += 1
        if tel.tracing:
            tel.event("migrate", unit=unit_id, shard=target_idx,
                      from_shard=src_idx, cause=cause, cause_seq=cause_seq)
        for wid in wu.ever_leased:
            if wid not in target.workers:
                s = src.workers.get(wid)
                ghost = WorkerInfo(wid, s.joined if s else 0.0)
                ghost.alive = s.alive if s else False
                target.workers[wid] = ghost

    def _settle_ledger(self, src: VolunteerScheduler,
                       target: VolunteerScheduler, wid: str) -> None:
        """A worker's home slot moved: its credit/counters settle onto
        the new home shard.  The source keeps a zeroed record (it may
        still hold the worker's leases on unmoved units), so the merged
        ``workers`` view conserves every counter."""
        info = src.workers[wid]
        m = target.workers.get(wid)
        if m is None:
            m = WorkerInfo(wid, info.joined)
            m.alive = info.alive
            target.workers[wid] = m
        else:
            m.alive = m.alive or info.alive
        m.credit += info.credit
        m.completed += info.completed
        m.invalid += info.invalid
        m.uplink_bytes += info.uplink_bytes
        m.uplink_dedup += info.uplink_dedup
        m.backoff_until = max(m.backoff_until, info.backoff_until)
        m.backoff_k = max(m.backoff_k, info.backoff_k)
        info.credit = 0.0
        info.completed = info.invalid = 0
        info.uplink_bytes = info.uplink_dedup = 0

    def _migrate_slots(self, slots: List[int], target_idx: int, *,
                       cause: str, cause_seq: int = 0,
                       settle_ledgers: bool = True) -> Dict[str, int]:
        """The reusable handoff primitive under failover, join, split and
        rejoin: move ownership of ``slots`` to shard ``target_idx`` and
        migrate every resident unit from its current owner, exactly as
        failover does — open units travel with results + lease history,
        live leases drop and re-issue, completed units copy so late
        reports still see them, and (``settle_ledgers``) per-worker
        ledgers of workers homed on the moved slots settle onto the
        target.  ``fail_shard`` passes ``settle_ledgers=False`` and does
        its own full-worker merge, since the whole source retires."""
        tel = self.tel
        slots = [s for s in slots if self._range_owner[s] != target_idx]
        totals = {"slots": len(slots), "reassigned_open": 0,
                  "copied_completed": 0, "dropped_leases": 0}
        if not slots:
            return totals
        by_owner: Dict[int, List[int]] = {}
        for slot in slots:
            owner = self._range_owner[slot]
            by_owner.setdefault(owner, []).append(slot)
            self._range_owner[slot] = target_idx
            self.metrics.slot_handoffs.inc()
            if tel.tracing:
                tel.event("slot_handoff", shard=target_idx, slot=slot,
                          from_shard=owner, cause=cause,
                          cause_seq=cause_seq)
        for src_idx in sorted(by_owner):
            src = self.shards[src_idx]
            moved_slots = set(by_owner[src_idx])
            moved_uids = [uid for uid in src.units
                          if self.unit_slot(uid) in moved_slots
                          and self._unit_shard.get(uid) == src_idx]
            for uid in moved_uids:
                self._move_unit(uid, src.units[uid], src, src_idx,
                                target_idx, totals, cause=cause,
                                cause_seq=cause_seq)
                del src.units[uid]
            if moved_uids:
                # the source stays live: rebuild its open index without
                # the departed units (its lease heap self-heals lazily)
                src._open = deque(u for u in src._open if u in src.units
                                  and not src.units[u].completed)
                src._open_stale = 0
                src._n_open = len(src._open)
            if settle_ledgers:
                for wid in sorted(src.workers):
                    if self.slot_of(wid) in moved_slots:
                        self._settle_ledger(src, self.shards[target_idx],
                                            wid)
        self.metrics.migrated_units.inc(totals["reassigned_open"])
        return totals

    def _take_slots(self, target_idx: int, n: int, *, cause: str,
                    cause_seq: int = 0) -> Dict[str, int]:
        """A joining/rejoining shard earns ``n`` slots: repeatedly take
        the heaviest slot from the currently most-loaded other owner
        (each owner keeps at least one slot).  Deterministic."""
        slot_load = self._slot_backlog()
        owned: Dict[int, List[int]] = {}
        for slot, owner in enumerate(self._range_owner):
            if owner != target_idx and self.shard_alive[owner]:
                owned.setdefault(owner, []).append(slot)
        load = {i: float(self.shards[i].open_backlog()) for i in owned}
        taken: List[int] = []
        for _ in range(n):
            donors = [i for i, sl in owned.items() if len(sl) > 1]
            if not donors:
                break
            donor = max(donors, key=lambda i: (load[i], -i))
            slot = max(owned[donor],
                       key=lambda s: (slot_load.get(s, 0), -s))
            owned[donor].remove(slot)
            load[donor] -= slot_load.get(slot, 0)
            taken.append(slot)
        return self._migrate_slots(taken, target_idx, cause=cause,
                                   cause_seq=cause_seq)

    # ---------------- elastic membership: join / split / rejoin --------
    def add_shard(self) -> int:
        """A new ``VolunteerScheduler`` joins the plane and takes its
        fair share of range slots from the most-loaded owners; -> the
        new shard's index."""
        self.flush_reports()
        index = len(self.shards)
        self.shards.append(self._new_shard(index))
        self.shard_alive.append(True)
        self.n_shards += 1
        self._shard_req.append(self._scope.counter(f"requests_shard{index}"))
        self._req_mark.append(0)
        self.metrics.shard_joins.inc()
        jseq = self.tel.event("shard_join", shard=index,
                              cause="add_shard") if self.tel.tracing else 0
        share = self.n_slots // len(self.alive_shards())
        info = self._take_slots(index, share, cause="shard_join",
                                cause_seq=jseq)
        if self.tel.tracing:
            self.tel.event("rebalance", shard=index, cause="shard_join",
                           cause_seq=jseq, **info)
        return index

    def split_shard(self, index: int,
                    target: Optional[int] = None) -> Dict[str, int]:
        """Split a hot shard: hand off half of its slots (greedy backlog
        halving — the heavier half of each pair leaves) to ``target``,
        default the least-loaded other alive shard.  Open units, lease
        history and per-worker ledgers travel exactly as failover moves
        them; -> handoff summary."""
        if not self.shard_alive[index]:
            raise ValueError(f"cannot split dead shard {index}")
        owned = [s for s, o in enumerate(self._range_owner) if o == index]
        if len(owned) < 2:
            raise ValueError(f"shard {index} owns {len(owned)} slot(s); "
                             f"nothing to split")
        others = [i for i in self.alive_shards() if i != index]
        if not others:
            raise ValueError("cannot split the only alive shard")
        if target is None:
            target = min(others,
                         key=lambda i: (self.shards[i].open_backlog(), i))
        if target == index or not self.shard_alive[target]:
            raise ValueError(f"bad split target {target}")
        self.flush_reports()
        self.metrics.shard_splits.inc()
        sseq = self.tel.event("shard_split", shard=index,
                              target=target) if self.tel.tracing else 0
        # greedy halving by backlog: heaviest slot first, each to the
        # currently lighter half; the kept half gets the first (hottest)
        slot_load = self._slot_backlog()
        keep_w = give_w = 0
        give: List[int] = []
        for slot in sorted(owned,
                           key=lambda s: (-slot_load.get(s, 0), s)):
            if give_w < keep_w or (give_w == keep_w
                                   and len(give) * 2 < len(owned) - 1):
                give.append(slot)
                give_w += slot_load.get(slot, 0)
            else:
                keep_w += slot_load.get(slot, 0)
        if not give:                       # all load on one slot: still
            give = [owned[-1]]             # hand off a coldest slot
        info = self._migrate_slots(give, target, cause="shard_split",
                                   cause_seq=sseq)
        info["split"] = index
        info["target"] = target
        return info

    def rejoin_shard(self, index: int) -> Dict[str, int]:
        """A killed shard returns: it comes back *empty* (its state was
        retired at failover) and earns its share of slots back from the
        most-loaded owners; -> handoff summary."""
        if self.shard_alive[index]:
            raise ValueError(f"shard {index} is already alive")
        self.flush_reports()
        self.shard_alive[index] = True
        self.metrics.shard_joins.inc()
        jseq = self.tel.event("shard_join", shard=index,
                              cause="rejoin") if self.tel.tracing else 0
        share = self.n_slots // len(self.alive_shards())
        info = self._take_slots(index, share, cause="shard_rejoin",
                                cause_seq=jseq)
        if self.tel.tracing:
            self.tel.event("rebalance", shard=index, cause="shard_rejoin",
                           cause_seq=jseq, **info)
        return info

    def rebalance(self, *, factor: float = 2.0,
                  min_backlog: int = 16) -> Optional[Dict[str, int]]:
        """One elastic-policy step (the ``--rebalance`` hook): when the
        hottest alive shard's open backlog exceeds ``factor``× the
        coldest's and ``min_backlog``, split it into the coldest; ->
        the split summary, or None when balanced."""
        alive = self.alive_shards()
        if len(alive) < 2:
            return None
        hot = max(alive, key=lambda i: (self.shards[i].open_backlog(), -i))
        cold = min(alive, key=lambda i: (self.shards[i].open_backlog(), i))
        hb = self.shards[hot].open_backlog()
        cb = self.shards[cold].open_backlog()
        if hot == cold or hb < min_backlog or hb <= factor * max(cb, 1):
            return None
        if sum(1 for o in self._range_owner if o == hot) < 2:
            return None
        return self.split_shard(hot, target=cold)

    # ---------------- failover ----------------
    def fail_shard(self, index: int) -> Dict[str, int]:
        """Kill shard ``index``: reassign its key-range slots to the
        survivors (backlog-aware placement) and migrate its state
        through the same ``_migrate_slots`` primitive joins and splits
        use.

        * open units move to the new owner of their range slot — results,
          lease history (``ever_leased``) and escalation counters travel,
          live leases drop (counted) and re-issue on the target;
        * completed units copy over so late reports and credit settling
          still see them; the un-drained completion log is preserved;
        * per-worker credit/counters merge into each worker's *new* home
          shard — total minted credit is conserved.

        -> migration summary dict."""
        if not self.shard_alive[index]:
            raise ValueError(f"shard {index} is already down")
        survivors = [i for i in self.alive_shards() if i != index]
        if not survivors:
            raise ValueError("cannot kill the last alive shard")
        # drain the report inbox first: buffered results must apply where
        # their workers are joined, or their credit share would vanish
        # when the unit completes on a shard that never saw the worker
        self.flush_reports()
        self.shard_alive[index] = False
        self.metrics.shard_kills.inc()
        tel = self.tel
        kseq = tel.event("kill_shard", shard=index) if tel.tracing else 0
        dead = self.shards[index]
        # preserve completions that were not yet drained
        self._migrated_completed.extend(dead.drain_completed())
        owned = [s for s, o in enumerate(self._range_owner) if o == index]
        placement = self._place_slots(owned, survivors)
        totals = {"reassigned_open": 0, "copied_completed": 0,
                  "dropped_leases": 0}
        for tgt in sorted(placement):
            info = self._migrate_slots(placement[tgt], tgt,
                                       cause="shard_kill", cause_seq=kseq,
                                       settle_ledgers=False)
            for k in totals:
                totals[k] += info[k]
        # stragglers: units resident here whose slot is owned elsewhere
        # (kept in place by an earlier migration) move to their owner
        for uid in list(dead.units):
            self._move_unit(uid, dead.units[uid], dead, index,
                            self._range_owner[self.unit_slot(uid)],
                            totals, cause="shard_kill", cause_seq=kseq)
            del dead.units[uid]
        # merge volunteer accounting into each worker's new home shard
        for wid, info in dead.workers.items():
            home = self.shards[self.home_shard(wid)]
            m = home.workers.get(wid)
            if m is None or not m.alive:
                m = home.join(wid) if info.alive else \
                    home.workers.setdefault(wid, WorkerInfo(wid, info.joined))
                m.alive = info.alive
            m.credit += info.credit
            m.completed += info.completed
            m.invalid += info.invalid
            m.uplink_bytes += info.uplink_bytes
            m.uplink_dedup += info.uplink_dedup
            m.backoff_until = max(m.backoff_until, info.backoff_until)
            m.backoff_k = max(m.backoff_k, info.backoff_k)
        # retire the dead shard's state so aggregate stats don't double
        # count workers and the view classes skip it
        dead.units = {}
        dead._open.clear()
        dead._open_stale = 0
        dead._n_open = 0
        dead._lease_heap.clear()
        dead._worker_leases.clear()
        dead.workers = {}
        return totals

    def shard_report(self) -> List[Dict[str, int]]:
        """Per-shard load view (benchmarks / ops)."""
        return [{"shard": i, "alive": int(self.shard_alive[i]),
                 "open": s.open_backlog(), "workers": len(s.workers),
                 "dispatched": s.stats["dispatched"],
                 "completed": s.stats["completed"]}
                for i, s in enumerate(self.shards)]
