"""Replicated snapshot chains across volunteer hosts.

The paper's V-BOINC server is a single trusted node: every capsule fetch
and result upload flows through one ChunkStore, so one disk loss destroys
every snapshot chain.  Volunteer fleets have enormous *storage* capacity
(Anderson & Fedak), and PRs 1+4 already give us a verified, dedup-aware
object protocol in both directions (the ``Wire`` verbs: ``plan_send``/
``send`` down, ``plan_recv``/``recv`` up) — a ``ReplicaSet`` fans every
primary write out over exactly that machinery so any peer can take over.

Design:

* **Write path** — ``put``/``put_delta``/``put_buffer``/``ingest`` write
  to the primary and append the new ref to a *bounded outbox*; the
  snapshot hot path never blocks on a peer (enqueue is O(1), no peer I/O).
  ``pump`` drains the outbox off the hot path: each ref's chain closure is
  exported from the primary (``send``) and ``recv``-ed by every alive peer that
  lacks any of it, so every replica re-hashes every record and validates
  chain depths — a corrupt primary cannot poison its peers.  Delivery is
  pluggable (``transport``) so the churn simulator can drop, delay and
  reorder messages deterministically; messages are self-contained chain
  closures, so redelivery and reordering are safe (recv is idempotent).
* **Read repair** — when ``resolve``/``get`` on the primary hits a
  missing or torn object (integrity = re-hash on read), the chain is
  healed in place from the first peer that can serve it: the packed
  records travel through ``recv``, which re-verifies every hash and
  chain depth before anything lands.
* **Failover** — ``promote`` redesignates any alive member as primary;
  the set keeps presenting the ChunkStore interface, so a
  ``VBoincServer`` or ``SnapshotManager`` holding the set transparently
  serves ``fetch_capsule``/``report_result``/``restore`` from the
  promoted peer (``VBoincServer.failover`` wires this).
* **GC** — ``gc`` marks the closure of live refs across the *whole set*
  (a delta record held only by the primary still pins its parent on every
  peer), sweeps the primary inline and defers the peer sweeps to the next
  ``pump`` — a peer never drops a parent the primary still references,
  and gc adds no peer I/O to the snapshot hot path either.
* ``replication_factor`` reports how many alive members hold a ref;
  ``sync`` is the anti-entropy pass that brings a revived member back up
  to date.

The outbox is bounded: under sustained peer outage old entries are
dropped (counted in ``rstats``) rather than stalling the writer — ``sync``
repairs the gap once a peer returns, exactly BOINC's eventual-consistency
posture toward flaky volunteers.
"""
from __future__ import annotations

import threading
from collections import deque
from typing import Callable, Dict, Iterable, List, Optional

from repro_torch.core import telemetry as tlm
from repro_torch.core.chunkstore import (DELTA_PREFIX, ChunkStore, _warn_wire,
                                   is_delta_ref)
from repro_torch.core.membership import Membership

DEFAULT_OUTBOX_LIMIT = 4096

# transport(peer_index, records) -> delivered?  (None = deliver in-process)
Transport = Callable[[int, Dict[str, bytes]], bool]


class ReplicaSet(Membership):
    """N chunk stores presenting one ChunkStore-shaped interface.

    ``members[primary_index]`` serves reads and takes writes; every write
    is asynchronously fanned to the alive peers through the bounded
    outbox.  Unknown attributes delegate to the current primary, so
    ``SnapshotManager``/``VBoincServer``/``push_update`` code written
    against ``ChunkStore`` runs unchanged against a ``ReplicaSet``.
    Membership verbs (``mark_down``/``mark_up``/``remove``/``promote``)
    come from the shared :class:`Membership` mixin — the same interface
    ``ChurnSim`` drives the edge-cache tier through — with the
    replica-specific bookkeeping (parked refs, promotion metrics) in the
    ``_on_*`` hooks.
    """

    def __init__(self, primary: ChunkStore, peers: Iterable[ChunkStore] = (),
                 *, outbox_limit: int = DEFAULT_OUTBOX_LIMIT,
                 transport: Optional[Transport] = None,
                 telemetry: Optional[tlm.Telemetry] = None):
        self._init_membership([primary, *peers])
        self.outbox: deque[str] = deque()
        self.outbox_limit = int(outbox_limit)
        self.transport = transport
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop: Optional[threading.Event] = None
        self._gc_keep: Optional[set[str]] = None   # deferred peer sweep
        # refs owed only to down members, re-queued on mark_up — keeps a
        # long outage from re-scanning the same refs every pump
        self._parked: Dict[int, deque[str]] = {}
        # telemetry registry behind the historical rstats shape; the
        # namespace is `rmetrics` (not `metrics`) so `.metrics` still
        # delegates to the primary ChunkStore via __getattr__
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("replica")
        self.rmetrics = scope.counters(
            "enqueued", "sent", "send_failed", "deferred",
            "outbox_dropped", "missing_at_pump", "repaired",
            "repair_failed", "promotions", "synced")
        self.rstats = scope.view()
        self._pump_hist = scope.histogram("pump_batch", tlm.SIZE_BUCKETS)

    # -- membership --------------------------------------------------------
    @property
    def primary(self) -> ChunkStore:
        return self.members[self.primary_index]

    def __getattr__(self, name: str):
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self.primary, name)

    def alive_peers(self) -> List[tuple[int, ChunkStore]]:
        return [(i, m) for i, m in enumerate(self.members)
                if i != self.primary_index and i not in self._down]

    # Membership hooks: the verbs themselves live on the shared mixin
    def _on_down(self, index: int) -> None:
        if self.tel.tracing:
            self.tel.event("member_down", member=index)

    def _on_up(self, index: int) -> None:
        """Refs parked for the member during its outage re-enter the
        outbox and ship on the next pump."""
        if self.tel.tracing:
            self.tel.event("member_up", member=index)
        with self._lock:
            for ref in self._parked.pop(index, ()):
                self.outbox.append(ref)
                if len(self.outbox) > self.outbox_limit:
                    self.outbox.popleft()
                    self.rmetrics.outbox_dropped.inc()

    def _on_remove(self, index: int) -> None:
        """Pumps stop deferring refs for a member that will never
        return (``index`` is its pre-removal slot)."""
        self._parked = {i - (i > index): q
                        for i, q in self._parked.items() if i != index}

    def _on_promote(self, index: int) -> None:
        self.rmetrics.promotions.inc()
        if self.tel.tracing:
            self.tel.event("promote", member=index)

    def promote_best(self) -> int:
        """Promote the alive member holding the most objects (deterministic
        tie-break: lowest index).  Returns the promoted index."""
        best, best_n = None, -1
        for i, m in enumerate(self.members):
            if i in self._down:
                continue
            n = sum(1 for _ in m.all_refs())
            if n > best_n:
                best, best_n = i, n
        if best is None:
            raise IOError("no alive member to promote")
        self.promote(best)
        return best

    def replication_factor(self, ref: str) -> int:
        """How many alive members hold ``ref``."""
        return sum(1 for i, m in enumerate(self.members)
                   if i not in self._down and m.has(ref))

    def replication_report(self, refs: Optional[Iterable[str]] = None) -> dict:
        """Factor summary over ``refs`` (default: the primary's objects)."""
        rs = list(refs) if refs is not None else list(self.primary.all_refs())
        target = len(self.members) - len(self._down)
        factors = [self.replication_factor(r) for r in rs]
        return {"objects": len(rs), "target": target,
                "min_factor": min(factors, default=target),
                "fully_replicated": sum(1 for f in factors if f >= target),
                "outbox": len(self.outbox),
                "parked": sum(len(q) for q in self._parked.values())}

    # -- hot write path: primary write + O(1) enqueue, no peer I/O ---------
    def _enqueue(self, ref: str) -> None:
        with self._lock:
            self.rmetrics.enqueued.inc()
            self.outbox.append(ref)
            if len(self.outbox) > self.outbox_limit:
                self.outbox.popleft()
                self.rmetrics.outbox_dropped.inc()

    def _park(self, index: int, ref: str) -> None:
        """Hold a ref owed to a down member (bounded, deduped, counted).
        Runs under the lock: ``mark_up``/``gc`` rebuild these queues, and
        the background pump must not append to an orphaned deque."""
        with self._lock:
            q = self._parked.setdefault(index, deque())
            if ref in q:
                return                   # a send-retry loop re-offers refs
            q.append(ref)
            self.rmetrics.deferred.inc()
            if len(q) > self.outbox_limit:
                q.popleft()
                self.rmetrics.outbox_dropped.inc()

    def put(self, data: bytes) -> str:
        h = self.primary.put(data)
        self._enqueue(h)
        return h

    def put_buffer(self, buf) -> list[str]:
        refs = self.primary.put_buffer(buf)
        for r in refs:
            self._enqueue(r)
        return refs

    def put_delta(self, parent_ref: str, xor_bytes: bytes, *,
                  full_bytes: Optional[bytes] = None) -> str:
        ref = self.primary.put_delta(parent_ref, xor_bytes,
                                     full_bytes=full_bytes)
        self._enqueue(ref)
        return ref

    def recv(self, records: Dict[str, bytes], *,
             client_id: Optional[str] = None) -> int:
        """Uplink writes replicate too: validated records land on the
        primary and their refs join the outbox."""
        written = self.primary.recv(records, client_id=client_id)
        for r in records:
            self._enqueue(r)
        return written

    def ingest(self, records: Dict[str, bytes], *,
               client_id: Optional[str] = None) -> int:
        """Deprecated: use ``recv``.  (Defined here, not delegated: the
        primary's shim would skip the replication enqueue.)"""
        _warn_wire("ReplicaSet.ingest", "recv")
        return self.recv(records, client_id=client_id)

    # -- read path with read-repair ----------------------------------------
    def get(self, ref: str) -> bytes:
        try:
            return self.primary.get(ref)
        except (OSError, KeyError):
            self.read_repair(ref)
            return self.primary.get(ref)

    def resolve(self, ref: str) -> bytes:
        try:
            return self.primary.resolve(ref)
        except (OSError, KeyError):
            self.read_repair(ref)
            return self.primary.resolve(ref)

    def get_buffer(self, refs: list[str]) -> bytes:
        return b"".join(self.get(r) for r in refs)

    def resolve_buffer(self, refs: list[str]) -> bytes:
        return b"".join(self.resolve(r) for r in refs)

    @staticmethod
    def _intact(store: ChunkStore, ref: str) -> bool:
        """Does ``store`` hold a hash-verified copy of ``ref``?"""
        try:
            if is_delta_ref(ref):
                store._delta_bytes(ref[len(DELTA_PREFIX):])
            else:
                store.get(ref)
            return True
        except (OSError, KeyError):
            return False

    def read_repair(self, ref: str) -> int:
        """Heal ``ref``'s chain on the primary from the first peer that can
        serve it.  Records re-enter through ``ingest``, so every healed
        object is re-hashed and its chain depth re-validated — a lying
        replica cannot poison the primary.  Returns objects healed."""
        if self.primary_index in self._down:
            raise IOError("primary is marked down; promote a replica first")
        for i, peer in self.alive_peers():
            try:
                closure = peer.live_closure([ref])
            except (OSError, KeyError):
                continue                     # peer lacks part of the chain
            bad = sorted(r for r in closure
                         if not self._intact(self.primary, r))
            try:
                records = peer.send(bad)
            except (OSError, KeyError):
                continue                     # peer torn too; try the next
            for r in bad:                    # drop torn copies first so the
                if self.primary.has(r):      # ingest dedup re-writes them
                    self.primary.delete(r)
            try:
                self.primary.recv(records)
            except (OSError, KeyError):
                continue
            self.rmetrics.repaired.inc(len(bad))
            if self.tel.tracing:
                self.tel.event("repair", ref=ref[:16], healed=len(bad),
                               peer=i)
            for r in bad:                    # healed objects may be missing
                self._enqueue(r)             # on other peers too
            return len(bad)
        self.rmetrics.repair_failed.inc()
        raise IOError(f"read-repair: no alive replica can heal {ref[:14]}")

    # -- replication pump (off the hot path) -------------------------------
    def _deliver(self, peer_index: int, records: Dict[str, bytes]) -> bool:
        if self.transport is not None:
            try:
                return bool(self.transport(peer_index, records))
            except Exception:
                return False
        return self.deliver_direct(peer_index, records)

    def deliver_direct(self, peer_index: int,
                       records: Dict[str, bytes]) -> bool:
        """Apply one replication message to a member (the in-process wire).
        Used directly by transports that queue messages for later/reordered
        delivery.  Any sweep deferred by an earlier ``gc`` is applied
        first — a stale keep set must never revert this delivery."""
        if peer_index in self._down:
            return False
        self._apply_deferred_gc()
        try:
            self.members[peer_index].recv(records)
        except (OSError, KeyError):
            return False
        return True

    def pump(self, max_msgs: Optional[int] = None) -> int:
        """Drain (a slice of) the outbox: fan each ref's chain closure to
        every peer that lacks any of it.  Returns messages sent.

        Failed sends re-queue the ref for the next pump.  A member marked
        *down* never silently drains the outbox: the ref is *parked* for
        it (``rstats["deferred"]``, bounded like the outbox) and re-queued
        by ``mark_up`` — so a long outage neither loses accounting nor
        re-scans the same refs every pump; ``remove`` forgets a member
        that will never return, and ``sync`` repairs any bounded drops on
        revival.  A ref the primary no longer holds is counted in
        ``rstats["missing_at_pump"]`` (benign when GC collected it first;
        after a failover it flags objects committed on the dead primary
        that never fanned out).  Each ref's closure is exported from the
        primary once and subset per peer.  Any peer sweep deferred by
        ``gc`` is applied first, so a ref delivered this cycle cannot be
        swept by an older live view."""
        self._apply_deferred_gc()
        with self._lock:
            batch = list(self.outbox)
            self.outbox.clear()
        n = len(batch) if max_msgs is None else min(len(batch), max_msgs)
        if n:
            self._pump_hist.observe(n)
        sent, retry = 0, []
        for ref in batch[:n]:
            # closure + export run under the primary's gc lock: a background
            # SnapshotWriter's trailing gc (its own thread) must not sweep a
            # chain between "has(ref)" and "export_records" — exports are
            # all-or-nothing per ref, deliveries happen outside the lock
            with self.primary.gc_lock:
                if not self.primary.has(ref):
                    self.rmetrics.missing_at_pump.inc()
                    continue
                try:
                    closure = self.primary.live_closure([ref])
                except (OSError, KeyError):
                    retry.append(ref)        # torn locally; read-repair may
                    continue                 # restore it before next pump
                failed = False
                targets: List[tuple[int, List[str]]] = []
                union: set[str] = set()
                for i in range(len(self.members)):
                    if i == self.primary_index:
                        continue
                    if i in self._down:
                        self._park(i, ref)   # owed; re-queued on mark_up
                        continue
                    needed = sorted(r for r in closure
                                    if not self.members[i].has(r))
                    if needed:
                        targets.append((i, needed))
                        union.update(needed)
                records = {}
                if union:
                    try:
                        records = self.primary.send(sorted(union))
                    except (OSError, KeyError):
                        retry.append(ref)
                        continue
            if records:
                for i, needed in targets:
                    if self._deliver(i, {r: records[r] for r in needed}):
                        self.rmetrics.sent.inc()
                        sent += 1
                    else:
                        self.rmetrics.send_failed.inc()
                        failed = True
            if failed:
                retry.append(ref)
        with self._lock:
            self.outbox.extendleft(reversed(batch[n:]))
            self.outbox.extend(retry)
            while len(self.outbox) > self.outbox_limit:
                self.outbox.popleft()
                self.rmetrics.outbox_dropped.inc()
        if n and self.tel.tracing:
            self.tel.event("pump", refs=n, sent=sent)
        return sent

    def flush(self, max_rounds: int = 64) -> int:
        """Pump until the outbox drains or stops making progress."""
        total = 0
        for _ in range(max_rounds):
            before = len(self.outbox)
            if not before:
                break
            total += self.pump()
            if len(self.outbox) >= before:
                break                        # every send failing; give up
        return total

    def sync(self, refs: Optional[Iterable[str]] = None) -> int:
        """Anti-entropy: replicate the closure of ``refs`` (default: every
        primary object) to every alive peer.  Brings a revived member back
        up to date and repairs outbox-overflow gaps.  Each missing object
        is read and hash-verified from the primary once, however many
        peers need it."""
        self._apply_deferred_gc()        # a stale sweep must not undo this
        base = list(refs) if refs is not None else \
            sorted(self.primary.all_refs())
        try:
            closure = self.primary.live_closure(base)
        except (OSError, KeyError):
            closure = set(base)
        needed_by_peer: List[tuple[int, List[str]]] = []
        union: set[str] = set()
        for i, peer in self.alive_peers():
            needed = [r for r in sorted(closure) if not peer.has(r)]
            if needed:
                needed_by_peer.append((i, needed))
                union.update(needed)
        records: Dict[str, bytes] = {}
        for r in sorted(union):
            try:
                records.update(self.primary.send([r]))
            except (OSError, KeyError):
                continue                     # torn locally; skip
        moved = 0
        for i, needed in needed_by_peer:
            msg = {r: records[r] for r in needed if r in records}
            if msg and self._deliver(i, msg):
                moved += len(msg)
        self.rmetrics.synced.inc(moved)
        return moved

    # -- GC: global closure mark, per-member sweep -------------------------
    def _parent_any(self, ref: str) -> Optional[str]:
        """A delta's parent ref, read from whichever member holds the
        record (primary first)."""
        order = [self.primary_index] + [i for i, _ in self.alive_peers()]
        for i in order:
            m = self.members[i]
            try:
                if m.has(ref):
                    return m._get_delta(ref).parent
            except (OSError, KeyError):
                continue
        return None

    def live_closure_all(self, refs: Iterable[str]) -> set[str]:
        """Closure over delta parents using records from *any* member — a
        chain half-replicated across the set still pins its parents
        everywhere."""
        keep: set[str] = set()
        stack = list(refs)
        while stack:
            r = stack.pop()
            if r in keep:
                continue
            keep.add(r)
            if is_delta_ref(r):
                p = self._parent_any(r)
                if p is not None:
                    stack.append(p)
        return keep

    def gc(self, live: set[str]) -> int:
        """Mark the *global* closure of ``live`` — a peer never drops a
        parent the primary still references (and vice versa) — then sweep
        the primary inline and defer the peer sweeps to the next ``pump``,
        keeping peer I/O off the snapshot hot path (``SnapshotManager``
        auto-gc calls this synchronously after every snapshot).  Returns
        objects removed from the primary, to match ``ChunkStore.gc``.

        Mark + primary sweep hold the primary's ``gc_lock`` (reentrant, so
        a SnapshotManager guard around this call nests fine): an async
        writer mid-commit holds the same lock, so this sweep can never see
        its objects before their manifest registers."""
        with self.primary.gc_lock:
            keep = self.live_closure_all(live)
            with self._lock:                 # dead refs need no replication
                self.outbox = deque(r for r in self.outbox if r in keep)
                self._parked = {i: deque(r for r in q if r in keep)
                                for i, q in self._parked.items()}
            dead = [r for r in self.primary.all_refs() if r not in keep]
            for r in dead:
                self.primary.delete(r)
            self.primary.sweep_tmp()
            self._gc_keep = keep             # newest live view wins
        return len(dead)

    def _apply_deferred_gc(self) -> None:
        """Sweep alive peers against the live view recorded by the last
        ``gc``.  Runs at the top of ``pump``, before any delivery, so an
        object replicated this cycle can never be swept by an older keep
        set.  A member down at sweep time keeps its garbage until the next
        gc after its revival (or a ``sync``)."""
        with self._lock:
            keep, self._gc_keep = self._gc_keep, None
        if keep is None:
            return
        for _, peer in self.alive_peers():
            for r in [r for r in peer.all_refs() if r not in keep]:
                peer.delete(r)
            peer.sweep_tmp()

    # -- optional background pump ------------------------------------------
    def start(self, interval_s: float = 0.05) -> None:
        """Drain the outbox from a daemon thread (production mode; tests
        drive ``pump`` explicitly for determinism)."""
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop():
            while not self._stop.wait(interval_s):
                self.pump()

        self._thread = threading.Thread(target=loop, daemon=True,
                                        name="replica-pump")
        self._thread.start()

    def stop(self) -> None:
        if self._thread is None:
            return
        self._stop.set()
        self._thread.join()
        self._thread = None
        self.flush()
