"""Edge capsule distribution: discovery service + delta-cache tier.

The paper's V-BOINC server is the sole distribution point: every volunteer
downloads its capsule (207 MB compressed image) straight from the project
server, so primary egress grows linearly with volunteer count — the exact
server-bandwidth bottleneck Anderson & Fedak quantify and that BOINC's
tiered mirrors address in production.  The delta ChunkStore already
shrank *what* moves; this layer changes *where it moves from*.

Two pieces, one subsystem:

* **Discovery** — a volunteer (or the server routing on its behalf) asks
  ``EdgeTier.discover(refs)``: "who can serve ref closure X?"  The answer
  is a ranked list of alive caches ordered by closure coverage (desc),
  load (fetches served, asc), simulated RTT (asc), with the *preferred*
  cache (``primary_index``, movable via the shared ``Membership.promote``)
  breaking ties.  Every ranking input is deterministic — RTT derives from
  the cache id's sha256, load from the serve count — so two same-seed
  churn schedules pick byte-identical routes.
* **Edge caches** — read-only ``ReplicaSet``-style members.  A cache holds
  a private ChunkStore plus an LRU keyed by *closure* (the chain-expanded
  ref set of one fetch): eviction drops whole closures and sweeps with the
  store's closure-marking GC, so a cache can never serve a torn delta
  chain.  On a miss the best-ranked cache **demand-fills** over the same
  ``Wire`` protocol volunteers speak (``plan_send`` → ``send`` → ``recv``
  — every record re-hashed on arrival), then serves; ``prefetch`` pushes
  hot base chunks to every alive cache ahead of a release wave.  Caches
  earn scheduler ``credit_transfer`` for the bytes they serve, exactly
  like a volunteer earns for uplink bytes — BOINC's credit economy
  extended to distribution.

Liveness churn (kill / revive / stale-revive) arrives through the shared
``Membership`` verbs, driven by ``ChurnSim`` — the same interface that
kills replicas and scheduler shards.  A killed cache drops out of
``discover`` immediately; a stale revive (``invalidate``) empties the
cache so it demand-fills before serving again.

Telemetry: the ``edge`` scope counts hits/misses/fills/evictions and
splits egress by origin vs cache; with tracing on, every routed fetch
emits a ``fetch_route`` event naming the serving member.
"""
from __future__ import annotations

import hashlib
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.core import telemetry as tlm
from repro_torch.core.chunkstore import ChunkStore, is_delta_ref
from repro_torch.core.membership import Membership

DEFAULT_CACHE_CAPACITY = 1 << 28            # 256 MiB per cache


def closure_key(refs: Iterable[str]) -> str:
    """Stable identity of one fetch's ref closure (sha256 of sorted refs)."""
    h = hashlib.sha256()
    for r in sorted(set(refs)):
        h.update(r.encode())
        h.update(b"\0")
    return h.hexdigest()


def simulated_rtt_ms(cache_id: str) -> int:
    """Deterministic per-cache RTT in [5, 55) ms, derived from the id.

    A hash, not a random draw: discovery rankings must be byte-identical
    across runs regardless of any RNG state."""
    return int(hashlib.sha256(cache_id.encode()).hexdigest()[:4], 16) % 50 + 5


class EdgeCache:
    """One read-only edge member: private store + LRU-by-closure eviction.

    The cache never takes volunteer writes — it is filled exclusively from
    the origin over the Wire protocol (``fill_from``), and everything it
    serves was therefore re-hashed on the way in.  Eviction operates on
    whole closures: a closure is admitted or dropped atomically, and the
    sweep is the store's own closure-marking GC over the union of resident
    closures, so a delta record can never outlive its parent here.
    """

    def __init__(self, cache_id: str, store: Optional[ChunkStore] = None, *,
                 capacity_bytes: int = DEFAULT_CACHE_CAPACITY):
        self.cache_id = cache_id
        self.store = store if store is not None else ChunkStore()
        self.capacity_bytes = int(capacity_bytes)
        self.rtt_ms = simulated_rtt_ms(cache_id)
        self.served_fetches = 0                  # the load signal
        # closure key -> (refs tuple, resident bytes); order = LRU
        self._lru: "OrderedDict[str, Tuple[Tuple[str, ...], int]]" = \
            OrderedDict()
        self._metrics = None                     # set by EdgeTier

    # -- queries -----------------------------------------------------------
    def resident_bytes(self) -> int:
        return sum(n for _, n in self._lru.values())

    def resident_refs(self) -> set[str]:
        return {r for refs, _ in self._lru.values() for r in refs}

    def coverage(self, refs: List[str]) -> float:
        """Fraction of ``refs`` this cache holds (1.0 = can serve now)."""
        if not refs:
            return 1.0
        have = sum(1 for r in refs if self.store.has(r))
        return have / len(refs)

    def can_serve(self, refs: List[str]) -> bool:
        return self.coverage(refs) >= 1.0

    # -- fill / serve ------------------------------------------------------
    def fill_from(self, origin: ChunkStore, refs: List[str]) -> int:
        """Demand-fill the closure of ``refs`` from ``origin`` over the
        Wire protocol; returns bytes moved (origin egress).  Records are
        re-hashed by ``recv`` — a corrupt origin cannot poison the tier."""
        plan = origin.plan_send(refs, self.resident_refs())
        moved = 0
        if plan.refs:
            records = origin.send(plan.refs)
            self.store.recv(records)
            moved = sum(len(b) for b in records.values())
        self._admit(origin.live_closure(refs))
        return moved

    def serve(self, refs: List[str]) -> Dict[str, bytes]:
        """Pack ``refs`` for a volunteer (cache egress, counts as load).

        Recency is keyed by *resident* closures, not the request's live
        closure: a subset fetch (or a request closed after a later fill)
        rarely hashes to any admitted closure key, so keying the touch by
        the request left hot closures looking cold to the LRU.  Touch
        every admitted closure the served refs intersect instead."""
        served = self.store.live_closure(refs)
        touched = [k for k, (crefs, _) in self._lru.items()
                   if not served.isdisjoint(crefs)]
        for k in touched:
            self._lru.move_to_end(k)
        self.served_fetches += 1
        return self.store.send(refs)

    def invalidate(self) -> None:
        """Stale revive: drop everything; the cache must demand-fill
        before it can serve again."""
        self._lru.clear()
        self.store.wipe()

    # -- eviction ----------------------------------------------------------
    def _admit(self, closure: set[str]) -> None:
        nbytes = sum(self.store.object_size(r) for r in closure
                     if self.store.has(r))
        key = closure_key(closure)
        if key in self._lru:
            self._lru.move_to_end(key)
        self._lru[key] = (tuple(sorted(closure)), nbytes)
        while (self.resident_bytes() > self.capacity_bytes
               and len(self._lru) > 1):
            self._lru.popitem(last=False)        # whole closures only
            if self._metrics is not None:
                self._metrics.evictions.inc()
        # sweep: anything outside the surviving closures leaves the store
        self.store.gc(self.resident_refs())


@dataclass
class FetchResult:
    """One routed fetch: the plan plus where the bytes came from."""
    missing: List[str]
    bytes_moved: int
    bytes_dedup: int
    route: str                       # "dedup", "origin", or a cache id
    records: Dict[str, bytes] = field(default_factory=dict)

    def _astuple(self):
        # legacy (missing, moved, dedup) unpacking, like TransferPlan
        return (self.missing, self.bytes_moved, self.bytes_dedup)

    def __iter__(self):
        return iter(self._astuple())

    def __len__(self):
        return 3

    def __getitem__(self, i):
        return self._astuple()[i]


class EdgeTier(Membership):
    """Discovery + routing over a set of edge caches in front of one origin.

    ``members`` are :class:`EdgeCache` instances sharing the
    :class:`Membership` liveness verbs with ``ReplicaSet`` — ``ChurnSim``
    kills, revives and promotes caches through the exact interface it
    drives replicas with.  ``primary_index`` is the *preferred* cache (the
    discovery tie-break), not a write target: the tier is read-only and
    the origin remains the single source of truth.
    """

    def __init__(self, origin: ChunkStore,
                 caches: Iterable[EdgeCache] = (), *,
                 scheduler=None,
                 telemetry: Optional[tlm.Telemetry] = None):
        self.origin = origin
        self.scheduler = scheduler
        self._init_membership(list(caches))
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("edge")
        self.metrics = scope.counters(
            "fetches", "hits", "misses", "fills", "fill_bytes",
            "prefetch_bytes", "origin_egress_bytes", "cache_egress_bytes",
            "evictions")
        self.stats = scope.view()
        for c in self.members:
            c._metrics = self.metrics
        if scheduler is not None:
            for c in self.members:
                scheduler.join(c.cache_id)

    # -- membership hooks --------------------------------------------------
    def _on_down(self, index: int) -> None:
        if self.tel.tracing:
            self.tel.event("cache_down", cache=self.members[index].cache_id)

    def _on_up(self, index: int) -> None:
        if self.tel.tracing:
            self.tel.event("cache_up", cache=self.members[index].cache_id)

    def _on_promote(self, index: int) -> None:
        if self.tel.tracing:
            self.tel.event("cache_preferred",
                           cache=self.members[index].cache_id)

    # -- discovery ---------------------------------------------------------
    def discover(self, refs: List[str]) -> List[Tuple[int, EdgeCache]]:
        """Rank alive caches for serving ``refs``.

        Order: coverage desc, load (fetches served) asc, simulated RTT
        asc, preferred-cache tie-break, index.  A killed cache does not
        appear at all.  Every key is deterministic, so equal histories
        rank identically."""
        ranked = []
        for i in self.alive_indices():
            c = self.members[i]
            ranked.append((-c.coverage(refs), c.served_fetches, c.rtt_ms,
                           0 if i == self.primary_index else 1, i, c))
        ranked.sort(key=lambda t: t[:5])
        return [(t[4], t[5]) for t in ranked]

    # -- routing -----------------------------------------------------------
    def fetch(self, refs: List[str], client_has: Optional[set] = None, *,
              client_store: Optional[ChunkStore] = None) -> FetchResult:
        """Route one volunteer fetch through discovery.

        The transfer accounting (missing refs, bytes moved, bytes saved)
        is the origin's ``plan_send`` — identical to the no-edge path, so
        a restore is byte-for-byte the same no matter who served it; only
        *whose* egress meter runs differs.  With ``client_store`` the
        packed records are actually delivered (and re-hashed) there."""
        plan = self.origin.plan_send(refs, client_has or set())
        self.metrics.fetches.inc()
        if not plan.refs:
            self._trace_route("dedup", plan)
            return FetchResult(plan.refs, plan.bytes_moved,
                               plan.bytes_dedup, "dedup")
        ranked = self.discover(plan.refs)
        if not ranked:
            records = self.origin.send(plan.refs)
            self.metrics.misses.inc()
            self.metrics.origin_egress_bytes.inc(plan.bytes_moved)
            route = "origin"
        else:
            index, cache = ranked[0]
            filled = 0
            if not cache.can_serve(plan.refs):
                self.metrics.misses.inc()
                self.metrics.fills.inc()
                filled = cache.fill_from(self.origin, plan.refs)
                self.metrics.fill_bytes.inc(filled)
                self.metrics.origin_egress_bytes.inc(filled)
            else:
                self.metrics.hits.inc()
            records = cache.serve(plan.refs)
            self.metrics.cache_egress_bytes.inc(plan.bytes_moved)
            # credit settles only on bytes the cache served from
            # already-resident closures: on a demand-fill miss the origin
            # just moved ``filled`` of plan.bytes_moved itself (it is on
            # the origin_egress meter), so minting transfer credit for
            # the full plan double-paid every cold fetch
            resident = max(0, plan.bytes_moved - filled)
            if self.scheduler is not None and resident > 0:
                self.scheduler.credit_transfer(cache.cache_id, resident)
            route = cache.cache_id
        if client_store is not None:
            client_store.recv(records)
        self._trace_route(route, plan)
        return FetchResult(plan.refs, plan.bytes_moved, plan.bytes_dedup,
                           route, records)

    def _trace_route(self, route: str, plan) -> None:
        if self.tel.tracing:
            self.tel.event("fetch_route", route=route, refs=len(plan.refs),
                           bytes=plan.bytes_moved)

    # -- prefetch ----------------------------------------------------------
    def prefetch(self, refs: List[str], *, base_only: bool = True) -> int:
        """Warm every alive cache with (the closure of) ``refs`` ahead of a
        release wave.  ``base_only`` keeps only raw chunks — the shared
        capsule base every volunteer needs — and leaves per-volunteer delta
        chains to demand-fill.  Returns total bytes pushed."""
        want = [r for r in refs if not (base_only and is_delta_ref(r))]
        if not want:
            return 0
        total = 0
        for i in self.alive_indices():
            moved = self.members[i].fill_from(self.origin, want)
            total += moved
        self.metrics.prefetch_bytes.inc(total)
        self.metrics.origin_egress_bytes.inc(total)
        return total

    # -- introspection -----------------------------------------------------
    def cache_ids(self) -> List[str]:
        return [c.cache_id for c in self.members]

    def describe(self) -> List[dict]:
        """Deterministic per-cache summary (benchmarks/tests)."""
        return [{"cache_id": c.cache_id,
                 "alive": i not in self._down,
                 "resident_bytes": c.resident_bytes(),
                 "closures": len(c._lru),
                 "served_fetches": c.served_fetches,
                 "rtt_ms": c.rtt_ms}
                for i, c in enumerate(self.members)]
