"""Unified telemetry plane: metrics registry, lifecycle tracer, flight recorder.

Operating a volunteer fleet (paper §IV-C; Anderson 2018's monitoring
subsection) is impossible without per-unit visibility: when a unit
reissues at step 40k under churn, the operator must be able to answer
*which* shard kill, lease expiry or replica wipe caused it — from the
trace alone, deterministically.  This module is that substrate, shared
by every layer built since PR 1:

* a **metrics registry** — typed counters, gauges and fixed-bucket
  histograms that the scheduler, shard plane, replica set, chunk store,
  snapshot writer, serving engine and trainer register against.  Each
  component keeps its historical ``.stats`` dict *shape* as a read-only
  live :class:`StatsView`, so every existing test, benchmark and launch
  summary reads the same keys it always did;
* a **work-unit lifecycle tracer** — structured span events
  (``submit → dispatch/lease → report → quorum → fold``, reissue events
  with an explicit cause, store events ``put/ingest/pump/repair`` and
  control events ``kill_shard/promote/failover``) carrying unit id,
  worker key, shard id and a timestamp from the component's own clock
  (the tests' ``SimClock``), so a fixed seed yields a byte-identical
  event stream;
* a bounded **flight recorder** — events land in a ring buffer
  (``deque(maxlen=capacity)``) that ``ChurnSim`` and the trainer dump to
  JSONL on fault or on demand;
* :func:`trace_reduce` — the post-mortem tool: reconstructs per-unit
  causal chains from a dump and flags anomalies (unclosed spans, quorum
  without a lease, reissue storms, reissues with no recorded cause).

The hub is process-wide by default (module-level instance, so components
constructed without an explicit ``telemetry=`` all share it) but fully
injectable: tests build isolated ``Telemetry(...)`` instances per run
and pass them down, which is what makes the two-runs-same-seed
byte-identity assertion possible in one process.

Tracing is off by default.  The disabled path is one attribute check in
``event()`` (and hot paths guard with ``if tel.tracing`` before building
kwargs).

Wall-clock spans
----------------

Beside the events the hub keeps a second bounded ring, ``spans``: one
``(name, start, end, thread name)`` tuple per timed piece of work, with
``start``/``end`` from ``time.perf_counter`` whatever the hub's ``clock``
is, so the events keep their deterministic ``SimClock`` stamps while the
spans line up with a benchmark's window and a device trace.  ``span(name)``
times a ``with`` block; ``add_span(name, start)`` closes a span whose
start was stamped earlier (a request's queue wait).  ``deque.append`` is
atomic, so a background thread (the snapshot writer) records into the
same ring.  Recording is always on: two clock reads and one append a
span, measured at 1.9 µs a ``span`` block and 0.4 µs an ``add_span`` on
an H100 host's CPU, against 5–6 spans a second in training and 14–15
in serving (PERF.md).  The names the port records:

* ``trainer.round``, ``trainer.unit``, ``trainer.update``, and inside the
  quorum hash ``trainer.hash.copy`` (a leaf's device-to-host copy) and
  ``trainer.hash.digest`` (its blake2b update), once per leaf;
* ``snapshot.plan`` (device probe and tile transfer),
  ``snapshot.backpressure`` (the writer queue's blocked ``put``) and
  ``snapshot.write`` (on the writer's thread in async mode);
* ``engine.queue`` (a request's wait from its hand-off to its admission),
  ``engine.admit``, ``engine.step`` (a decode step and its token
  readback) and ``engine.step.dispatch`` (the host's part of the decode
  call).

``launch/train.py --telemetry DIR`` and ``launch/serve.py --slots N
--telemetry DIR`` write the ring as ``spans.jsonl``.

Reading a flight-recorder dump: one lost unit, end to end
---------------------------------------------------------

Say a churn run reports one reissue you did not expect.  The trainer (or
``ChurnSim`` with ``dump_on_fault=``) wrote ``events.jsonl``; grep the
unit::

    $ grep '"unit": 17' events.jsonl
    {"kind": "submit", "quorum": 1, "replication": 1, "seq": 402,
     "shard": 1, "t": 84.0, "unit": 17}
    {"kind": "dispatch", "dup": false, "seq": 431, "shard": 1,
     "t": 84.0, "unit": 17, "worker": "v3"}
    {"kind": "lease", "deadline": 144.0, "seq": 432, "shard": 1,
     "t": 84.0, "unit": 17, "worker": "v3"}
    {"cause": "shard_kill", "cause_seq": 440, "kind": "lease_drop",
     "seq": 445, "shard": 1, "t": 91.0, "unit": 17, "worker": "v3"}
    {"kind": "dispatch", "dup": false, "seq": 471, "shard": 2,
     "t": 91.0, "unit": 17, "worker": "v5"}
    ...
    {"kind": "quorum", "canonical": "9f2c...", "results": 1,
     "seq": 505, "shard": 2, "t": 91.0, "unit": 17}
    {"kind": "fold", "seq": 530, "t": 91.0, "unit": 17}

The story reads straight off the chain: unit 17 was submitted to shard
1, leased to worker ``v3``, and the lease was dropped — not by a worker
death or a deadline, but by ``cause: shard_kill`` pointing (via
``cause_seq: 440``) at the exact fault event::

    $ grep '"seq": 440' events.jsonl
    {"kind": "kill_shard", "seq": 440, "shard": 1, "t": 91.0}

After the kill the unit migrated (a ``migrate`` event with
``from_shard: 1``), re-dispatched on shard 2, met quorum and was folded
into the round — a closed ``submit → … → fold`` span.  Running
``python -m repro_torch.core.telemetry events.jsonl`` does this for every
unit at once: it prints chain/anomaly counts and would have flagged the
unit as ``unattributed_reissue`` had the ``cause`` field been missing,
or ``unclosed_span`` had it never reached quorum.
"""
from __future__ import annotations

import json
import threading
import time
from bisect import bisect_left
from collections import deque
from collections.abc import Mapping
from contextlib import contextmanager
from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "Counter", "Gauge", "Histogram", "MetricScope", "StatsView",
    "Telemetry", "TraceReport", "get_default", "set_default", "resolve",
    "trace_reduce", "TIME_BUCKETS_S", "SIZE_BUCKETS",
]

# latency buckets (seconds): 1us .. 1s, the dispatch/probe range
TIME_BUCKETS_S = (1e-6, 2e-6, 5e-6, 1e-5, 2e-5, 5e-5, 1e-4, 5e-4,
                  1e-3, 1e-2, 1e-1, 1.0)
# count/size buckets: pump batch sizes, report flush sizes
SIZE_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024, 4096)

DEFAULT_CAPACITY = 1 << 16


class Counter:
    """Monotonic-by-convention accumulator.  ``inc`` accepts negative
    deltas for the rare reconciliation path (e.g. the uplink dedup
    clawback when ingest validation rejects a batch) — the registry
    records what happened; policy lives in the caller."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def inc(self, n=1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Counter({self.name}={self.value})"


class Gauge:
    """Point-in-time value (queue depth, alive shards)."""

    __slots__ = ("name", "value")

    def __init__(self, name: str, value=0):
        self.name = name
        self.value = value

    def set(self, v) -> None:
        self.value = v

    def inc(self, n=1) -> None:
        self.value += n

    def __repr__(self) -> str:
        return f"Gauge({self.name}={self.value})"


class Histogram:
    """Fixed-bucket histogram (upper-bound semantics, like Prometheus
    ``le``): ``counts[i]`` tallies observations ``<= buckets[i]``, the
    final slot is +Inf.  Buckets are fixed at registration so exposition
    never allocates."""

    __slots__ = ("name", "buckets", "counts", "sum", "count")

    def __init__(self, name: str, buckets: Tuple[float, ...]):
        self.name = name
        self.buckets = tuple(buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.counts[bisect_left(self.buckets, v)] += 1
        self.sum += v
        self.count += 1

    def __repr__(self) -> str:
        return f"Histogram({self.name}, n={self.count})"


class StatsView(Mapping):
    """Read-only live dict view over a scope's scalar metrics.

    Preserves the historical ``component.stats["key"]`` read shape —
    ``dict(view)``, ``.items()``, ``.get()`` and ``in`` all work — while
    rejecting the old write shape: mutation must go through the typed
    metric objects (``component.metrics.key.inc()``), which is what the
    ``tools/lint_stats_mutations.py`` CI step enforces at the AST level.
    """

    __slots__ = ("_metrics",)

    def __init__(self, metrics: Dict[str, object]):
        self._metrics = metrics

    def __getitem__(self, key: str):
        return self._metrics[key].value

    def __iter__(self):
        return iter(self._metrics)

    def __len__(self) -> int:
        return len(self._metrics)

    def __setitem__(self, key, value):      # pragma: no cover - guard
        raise TypeError("stats is a read-only telemetry view; "
                        "use <component>.metrics.<key>.inc()")

    def __delitem__(self, key):             # pragma: no cover - guard
        raise TypeError("stats is a read-only telemetry view")

    def __repr__(self) -> str:
        return repr({k: m.value for k, m in self._metrics.items()})


class MetricScope:
    """One component's corner of the registry (``scheduler``,
    ``replica``, ...).  Scopes are cheap; every component instance gets
    its own, labeled with a hub-assigned instance index so Prometheus
    exposition can tell shards apart."""

    __slots__ = ("hub", "name", "index", "_scalars", "_histograms")

    def __init__(self, hub: "Telemetry", name: str, index: int):
        self.hub = hub
        self.name = name
        self.index = index
        self._scalars: Dict[str, object] = {}    # insertion-ordered
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, key: str, value=0) -> Counter:
        c = self._scalars.get(key)
        if c is None:
            c = self._scalars[key] = Counter(key, value)
        return c

    def counters(self, *keys: str) -> SimpleNamespace:
        """Register ``keys`` in order; -> namespace of Counter objects
        (the component's ``metrics`` handle — attribute access beats a
        dict lookup on the hot path)."""
        return SimpleNamespace(**{k: self.counter(k) for k in keys})

    def gauge(self, key: str, value=0) -> Gauge:
        g = self._scalars.get(key)
        if g is None:
            g = self._scalars[key] = Gauge(key, value)
        return g

    def histogram(self, key: str,
                  buckets: Tuple[float, ...] = TIME_BUCKETS_S) -> Histogram:
        h = self._histograms.get(key)
        if h is None:
            h = self._histograms[key] = Histogram(key, buckets)
        return h

    def view(self) -> StatsView:
        """Live read-only mapping over the scalars registered so far
        *and later* — the backward-compatible ``.stats`` face."""
        return StatsView(self._scalars)


class Telemetry:
    """The hub: scope factory, event recorder, exporters.

    ``clock`` is any zero-arg callable returning a float timestamp —
    pass the component graph's shared ``SimClock`` for deterministic
    traces (the default, wall time, is for live runs where byte
    identity does not matter).  ``tracing`` gates the recorder; metrics
    always count (they are the ``.stats`` backing store), and wall-clock
    spans always record (``span``, ``add_span``)."""

    def __init__(self, *, clock=None, tracing: bool = False,
                 capacity: int = DEFAULT_CAPACITY):
        self.clock = clock if clock is not None else time.time
        self.tracing = bool(tracing)
        self.capacity = int(capacity)
        self.events: deque = deque(maxlen=self.capacity)
        # (name, start, end, thread name), perf_counter seconds
        self.spans: deque = deque(maxlen=self.capacity)
        self._seq = 0
        self._scopes: List[MetricScope] = []
        self._scope_counts: Dict[str, int] = {}

    # ---------------- registry ----------------
    def scope(self, name: str) -> MetricScope:
        index = self._scope_counts.get(name, 0)
        self._scope_counts[name] = index + 1
        sc = MetricScope(self, name, index)
        self._scopes.append(sc)
        return sc

    # ---------------- recorder ----------------
    def event(self, kind: str, *, unit=None, worker=None, shard=None,
              **extra) -> int:
        """Record one structured event; -> its seq (0 when disabled).

        The seq is the causal handle: fault emitters capture it and
        stamp dependent events with ``cause=``/``cause_seq=`` at the
        source, so ``trace_reduce`` attributes reissues by reading the
        trace, never by inference."""
        if not self.tracing:
            return 0
        self._seq += 1
        ev = {"seq": self._seq, "t": self.clock(), "kind": kind}
        if unit is not None:
            ev["unit"] = unit
        if worker is not None:
            ev["worker"] = worker
        if shard is not None:
            ev["shard"] = shard
        if extra:
            ev.update(extra)
        self.events.append(ev)
        return self._seq

    def reset_events(self) -> None:
        self.events.clear()

    # ---------------- wall-clock spans ----------------
    def add_span(self, name: str, start: float) -> float:
        """Record span ``name`` from ``start`` (a ``time.perf_counter``
        stamp taken earlier) to now, on the calling thread; -> its end."""
        end = time.perf_counter()
        self.spans.append((name, start, end,
                           threading.current_thread().name))
        return end

    @contextmanager
    def span(self, name: str):
        """Time the ``with`` block as span ``name``."""
        start = time.perf_counter()
        try:
            yield
        finally:
            self.add_span(name, start)

    # ---------------- exporters ----------------
    def event_lines(self) -> List[str]:
        """Deterministic JSONL lines for the ring's current contents
        (sorted keys, fixed separators — byte-stable given a
        deterministic clock)."""
        return [json.dumps(ev, sort_keys=True, separators=(",", ":"))
                for ev in self.events]

    def dump_jsonl(self, path) -> int:
        """Write the flight recorder to ``path``; -> events written."""
        lines = self.event_lines()
        with open(path, "w") as f:
            for line in lines:
                f.write(line + "\n")
        return len(lines)

    def dump_spans_jsonl(self, path) -> int:
        """Write the span ring to ``path``, one span a line (sorted keys);
        -> spans written."""
        spans = list(self.spans)
        with open(path, "w") as f:
            for name, start, end, thread in spans:
                f.write(json.dumps({"name": name, "start": start, "end": end,
                                    "thread": thread}, sort_keys=True) + "\n")
        return len(spans)

    def prometheus(self) -> str:
        """Prometheus text exposition of every registered metric.
        Metric families are ``repro_<scope>_<key>`` with an
        ``instance`` label distinguishing multiple scopes of one name
        (e.g. per-shard schedulers)."""
        out: List[str] = []
        seen_type: set = set()
        for sc in self._scopes:
            label = f'{{scope="{sc.name}",instance="{sc.index}"}}'
            for key, m in sc._scalars.items():
                fam = f"repro_{sc.name}_{key}"
                if fam not in seen_type:
                    kind = "gauge" if isinstance(m, Gauge) else "counter"
                    out.append(f"# TYPE {fam} {kind}")
                    seen_type.add(fam)
                out.append(f"{fam}{label} {m.value}")
            for key, h in sc._histograms.items():
                fam = f"repro_{sc.name}_{key}"
                if fam not in seen_type:
                    out.append(f"# TYPE {fam} histogram")
                    seen_type.add(fam)
                cum = 0
                for le, c in zip(h.buckets, h.counts):
                    cum += c
                    out.append(f'{fam}_bucket{{scope="{sc.name}",'
                               f'instance="{sc.index}",le="{le}"}} {cum}')
                out.append(f'{fam}_bucket{{scope="{sc.name}",'
                           f'instance="{sc.index}",le="+Inf"}} {h.count}')
                out.append(f"{fam}_sum{label} {h.sum}")
                out.append(f"{fam}_count{label} {h.count}")
        return "\n".join(out) + "\n"


# ---------------- process-wide default hub ----------------
_DEFAULT = Telemetry()


def get_default() -> Telemetry:
    return _DEFAULT


def set_default(tel: Telemetry) -> Telemetry:
    """Install ``tel`` as the process default (launchers call this once
    before constructing the component graph); -> the previous default."""
    global _DEFAULT
    prev, _DEFAULT = _DEFAULT, tel
    return prev


def resolve(tel: Optional[Telemetry]) -> Telemetry:
    """Component constructors: explicit hub wins, else the default."""
    return tel if tel is not None else _DEFAULT


# ---------------- trace_reduce: post-mortem causal chains ----------------

# kinds that re-queue a unit and therefore demand a recorded cause
REISSUE_KINDS = frozenset({"reissue", "lease_drop"})
# kinds a cause_seq may legitimately point at
FAULT_KINDS = frozenset({"kill_shard", "worker_leave", "lease_expire",
                         "member_down", "wipe", "failover"})


@dataclass
class UnitChain:
    """Everything the trace says about one unit, in seq order."""
    unit: object
    submits: List[int] = field(default_factory=list)
    dispatches: List[Tuple[int, Optional[str]]] = field(default_factory=list)
    reports: List[Tuple[int, Optional[str]]] = field(default_factory=list)
    quorums: List[int] = field(default_factory=list)
    folds: List[int] = field(default_factory=list)
    reissues: List[dict] = field(default_factory=list)

    def closed(self, require_fold: bool = False) -> bool:
        ok = bool(self.submits and self.dispatches and self.reports
                  and self.quorums)
        if require_fold:
            ok = ok and bool(self.folds)
        return ok

    def stage(self) -> str:
        """Furthest lifecycle stage this unit reached."""
        for name in ("folds", "quorums", "reports", "dispatches", "submits"):
            if getattr(self, name):
                return name[:-1] if name != "dispatches" else "dispatch"
        return "none"


@dataclass
class TraceReport:
    units: Dict[object, UnitChain]
    anomalies: List[dict]
    reissues: int = 0
    attributed: int = 0
    completed: int = 0
    folded: int = 0
    events: int = 0

    @property
    def attribution_rate(self) -> float:
        return 1.0 if self.reissues == 0 else self.attributed / self.reissues

    def anomaly_kinds(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for a in self.anomalies:
            out[a["kind"]] = out.get(a["kind"], 0) + 1
        return out

    def summary(self) -> str:
        ak = self.anomaly_kinds()
        parts = [f"events={self.events}", f"units={len(self.units)}",
                 f"completed={self.completed}", f"folded={self.folded}",
                 f"reissues={self.reissues}",
                 f"attributed={self.attributed} "
                 f"({self.attribution_rate:.0%})",
                 f"anomalies={sum(ak.values())}"]
        if ak:
            parts.append("[" + ", ".join(f"{k}={v}"
                                         for k, v in sorted(ak.items()))
                         + "]")
        return "  ".join(parts)


def _iter_events(events) -> Iterable[dict]:
    if isinstance(events, Telemetry):
        return list(events.events)
    return events


def trace_reduce(events, *, storm_threshold: int = 5,
                 require_fold: bool = False) -> TraceReport:
    """Reconstruct per-unit causal chains from an event stream and flag
    anomalies.  ``events``: a ``Telemetry`` hub, an iterable of event
    dicts, or parsed JSONL lines.

    Anomalies flagged (each a dict with ``kind``, ``unit``, detail):

    * ``unclosed_span`` — a submitted unit that never reached quorum
      (or never folded, with ``require_fold=True``);
    * ``quorum_without_lease`` — quorum recorded for a unit with no
      dispatch event (forged or lost provenance);
    * ``report_without_lease`` — a worker reported a unit it was never
      dispatched (by this trace);
    * ``unattributed_reissue`` — a reissue/lease_drop with no recorded
      ``cause``, or a ``cause_seq`` pointing at a non-fault event;
    * ``reissue_storm`` — one unit reissued ``>= storm_threshold``
      times.
    """
    evs = _iter_events(events)
    by_seq: Dict[int, dict] = {}
    units: Dict[object, UnitChain] = {}
    anomalies: List[dict] = []
    reissues = attributed = completed = folded = n = 0
    any_fold = False

    def chain(uid) -> UnitChain:
        ch = units.get(uid)
        if ch is None:
            ch = units[uid] = UnitChain(uid)
        return ch

    for ev in evs:
        n += 1
        seq = ev.get("seq")
        if seq is not None:
            by_seq[seq] = ev
        kind = ev.get("kind")
        uid = ev.get("unit")
        if kind == "submit" and uid is not None:
            chain(uid).submits.append(seq)
        elif kind == "dispatch" and uid is not None:
            chain(uid).dispatches.append((seq, ev.get("worker")))
        elif kind == "report" and uid is not None:
            chain(uid).reports.append((seq, ev.get("worker")))
        elif kind == "quorum" and uid is not None:
            chain(uid).quorums.append(seq)
            completed += 1
        elif kind == "fold" and uid is not None:
            chain(uid).folds.append(seq)
            folded += 1
            any_fold = True
        elif kind in REISSUE_KINDS and uid is not None:
            chain(uid).reissues.append(ev)
            reissues += 1
            cause = ev.get("cause")
            cseq = ev.get("cause_seq")
            cause_ev = by_seq.get(cseq) if cseq else None
            ok = cause is not None and (
                cseq in (None, 0)
                or (cause_ev is not None
                    and cause_ev.get("kind") in FAULT_KINDS))
            if ok:
                attributed += 1
            else:
                anomalies.append({"kind": "unattributed_reissue",
                                  "unit": uid, "seq": seq,
                                  "cause": cause, "cause_seq": cseq})

    require_fold = require_fold or any_fold
    for uid, ch in units.items():
        if ch.quorums and not ch.dispatches:
            anomalies.append({"kind": "quorum_without_lease", "unit": uid,
                              "seq": ch.quorums[0]})
        if ch.submits and not ch.closed(require_fold=require_fold):
            anomalies.append({"kind": "unclosed_span", "unit": uid,
                              "stage": ch.stage()})
        leased_workers = {w for _, w in ch.dispatches}
        for seq, w in ch.reports:
            if w is not None and w not in leased_workers:
                anomalies.append({"kind": "report_without_lease",
                                  "unit": uid, "worker": w, "seq": seq})
        if len(ch.reissues) >= storm_threshold:
            anomalies.append({"kind": "reissue_storm", "unit": uid,
                              "count": len(ch.reissues)})

    return TraceReport(units=units, anomalies=anomalies, reissues=reissues,
                       attributed=attributed, completed=completed,
                       folded=folded, events=n)


def load_jsonl(path) -> List[dict]:
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def main(argv=None) -> int:
    """CLI: ``python -m repro_torch.core.telemetry dump.jsonl`` — print the
    post-mortem summary and every anomaly."""
    import argparse
    ap = argparse.ArgumentParser(
        description="trace_reduce: per-unit causal chains from a "
                    "flight-recorder JSONL dump")
    ap.add_argument("dump", help="JSONL event dump (Telemetry.dump_jsonl)")
    ap.add_argument("--storm-threshold", type=int, default=5)
    ap.add_argument("--unit", default=None,
                    help="print the raw chain for one unit id")
    args = ap.parse_args(argv)
    events = load_jsonl(args.dump)
    rep = trace_reduce(events, storm_threshold=args.storm_threshold)
    print(rep.summary())
    if args.unit is not None:
        uid = int(args.unit)
        for ev in events:
            if ev.get("unit") == uid or ev.get("seq") in {
                    r.get("cause_seq") for r in
                    rep.units.get(uid, UnitChain(uid)).reissues}:
                print(" ", json.dumps(ev, sort_keys=True))
    for a in rep.anomalies:
        print(f"ANOMALY {a}")
    return 1 if rep.anomalies else 0


if __name__ == "__main__":
    raise SystemExit(main())
