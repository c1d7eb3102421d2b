"""Deterministic churn fault injection for the replication subsystem.

``ChurnSim`` drives a ``ReplicaSet`` through a scripted sequence of
steps — snapshot/uplink work on the hot path, replication pumps, message
delivery, and faults (kill/wipe/revive/promote, message drops, reordered
delivery) — with every random choice drawn from one seeded generator, so
a failing schedule replays bit-for-bit from its seed.

The same simulator also churns the *scheduler plane*: constructed with
``shards=`` (a ``ShardedScheduler``) it churns scheduler membership —
scripted (``kill_shard``, ``add_shard``, ``split_hot_shard``,
``rejoin_shard``) or seeded (``random_shard_kill``) — so the elastic
handoff path (key-range reassignment + open-unit migration) is
exercised by the exact deterministic machinery that already drives
replica failover.  With ``edges=`` (an ``EdgeTier``) it churns the
edge-cache tier through the same shared ``Membership`` verbs:
``kill_cache``/``revive_cache`` (optionally *stale* — the cache comes
back empty and must demand-fill before serving) and seeded
``random_cache_kill``.  A sim may drive any combination of the three
planes.

Two instruments make the fault-injection suite's assertions possible:

* **message interception** — the sim installs itself as the set's
  ``transport``: pumped messages are captured in flight instead of being
  applied, then delivered (optionally in scrambled order) at an explicit
  ``deliver`` step.  ``drop(n)`` discards the next n sends, exercising the
  retry path; down members black-hole their messages.
* **step accounting** — every member's ``recv`` (Wire sink verb) is
  wrapped to log
  ``(step, phase, member, primary_at_the_time, records)``.  Scripted steps
  run in a named phase ("hot" for snapshot/training work, "net" for
  pump/deliver, "fault" for churn events), so a test can assert that *no
  peer ingest ever ran during a hot step* — replication adds zero blocking
  I/O to the snapshot hot path.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.core import telemetry as tlm
from repro_torch.core.replica import ReplicaSet


class ChurnSim:
    """Scripted, seedable kill/revive/drop/reorder churn for a ReplicaSet."""

    def __init__(self, replicas: Optional[ReplicaSet] = None, seed: int = 0,
                 *, shards=None, edges=None,
                 telemetry: Optional[tlm.Telemetry] = None,
                 dump_on_fault: Optional[Path] = None):
        if replicas is None and shards is None and edges is None:
            raise ValueError(
                "ChurnSim needs replicas=, shards= and/or edges=")
        self.replicas = replicas
        self.shards = shards           # a ShardedScheduler (or None)
        self.edges = edges             # an EdgeTier (or None)
        # the flight-recorder hook: dump the hub's ring to
        # <dump_on_fault>/fault-<step>-<kind>.jsonl after every fault step
        self.tel = tlm.resolve(telemetry)
        self.dump_on_fault = Path(dump_on_fault) if dump_on_fault else None
        if self.dump_on_fault is not None:
            self.dump_on_fault.mkdir(parents=True, exist_ok=True)
        self.rng = np.random.default_rng(seed)
        self.step = 0
        self.phase = "idle"
        self.in_flight: List[tuple[int, Dict[str, bytes]]] = []
        self.drop_next = 0
        self.events: List[tuple[int, str, object]] = []
        # (step, phase, member, primary_index at log time, record count)
        self.ingest_log: List[tuple[int, str, int, int, int]] = []
        if replicas is not None:
            replicas.transport = self._transport
            self._instrument()

    # -- instrumentation ---------------------------------------------------
    def _instrument(self) -> None:
        # wrap the Wire sink verb on each member *instance*; the deprecated
        # ingest shim calls self.recv, so shimmed callers are logged too
        for idx, member in enumerate(self.replicas.members):
            member.recv = self._wrap_recv(idx, member.recv)

    def _wrap_recv(self, idx: int, orig: Callable) -> Callable:
        def recv(records, *, client_id=None):
            self.ingest_log.append((self.step, self.phase, idx,
                                    self.replicas.primary_index,
                                    len(records)))
            return orig(records, client_id=client_id)
        return recv

    def _transport(self, peer_index: int, records: Dict[str, bytes]) -> bool:
        if peer_index in self.replicas._down:
            self._log("blackhole", peer_index)
            return False
        if self.drop_next > 0:
            self.drop_next -= 1
            self._log("drop", peer_index)
            return False
        self.in_flight.append((peer_index, records))
        self._log("send", peer_index)
        return True

    def _log(self, kind: str, detail: object) -> None:
        self.events.append((self.step, kind, detail))

    def dump(self, path) -> int:
        """Dump the telemetry flight recorder to ``path`` (JSONL)."""
        return self.tel.dump_jsonl(path)

    def _dump_fault(self, kind: str) -> None:
        if self.dump_on_fault is not None:
            self.dump(self.dump_on_fault / f"fault-{self.step:04d}-{kind}.jsonl")

    def _tick(self, phase: str) -> None:
        self.step += 1
        self.phase = phase

    def _need_replicas(self) -> ReplicaSet:
        if self.replicas is None:
            raise RuntimeError("this step needs replicas=; the sim was "
                               "built to drive scheduler shards only")
        return self.replicas

    # -- scripted steps ----------------------------------------------------
    def hot(self, fn: Callable[[], object]):
        """Run snapshot/training work as a hot-path step; any peer I/O in
        here is a failure the accounting will expose."""
        self._tick("hot")
        try:
            return fn()
        finally:
            self.phase = "idle"

    def pump(self, max_msgs: Optional[int] = None) -> int:
        self._need_replicas()
        self._tick("net")
        try:
            return self.replicas.pump(max_msgs)
        finally:
            self.phase = "idle"

    def deliver(self, shuffle: bool = True) -> int:
        """Deliver captured in-flight messages, scrambled (seeded) when
        ``shuffle`` — the reorder fault.  Chain-closure messages are
        self-contained, so any order must converge."""
        self._need_replicas()
        self._tick("net")
        try:
            msgs, self.in_flight = self.in_flight, []
            if shuffle and len(msgs) > 1:
                msgs = [msgs[i] for i in self.rng.permutation(len(msgs))]
            delivered = 0
            for peer_index, records in msgs:
                if peer_index in self.replicas._down:
                    self._log("lost", peer_index)
                    continue
                if self.replicas.deliver_direct(peer_index, records):
                    delivered += 1
            return delivered
        finally:
            self.phase = "idle"

    def drop(self, n: int = 1) -> None:
        """Discard the next ``n`` replication sends (retried next pump)."""
        self.drop_next += n

    def kill(self, index: int, wipe: bool = False) -> None:
        """Mark a member down; ``wipe`` simulates full disk loss."""
        self._need_replicas()
        self._tick("fault")
        self.replicas.mark_down(index)
        if wipe:
            self.replicas.members[index].wipe()
        self._log("kill", (index, wipe))
        self._dump_fault("kill")
        self.phase = "idle"

    def revive(self, index: int, sync: bool = False) -> None:
        self._need_replicas()
        self._tick("fault")
        self.replicas.mark_up(index)
        self._log("revive", index)
        self._dump_fault("revive")
        self.phase = "idle"
        if sync:
            self._tick("net")
            self.replicas.sync()
            self.deliver(shuffle=False)

    def promote(self, index: Optional[int] = None) -> int:
        self._need_replicas()
        self._tick("fault")
        if index is None:
            index = self.replicas.promote_best()
        else:
            self.replicas.promote(index)
        self._log("promote", index)
        self._dump_fault("promote")
        self.phase = "idle"
        return index

    # -- scheduler-shard churn --------------------------------------------
    def _need_shards(self):
        if self.shards is None:
            raise RuntimeError("sim was built without shards=")
        return self.shards

    def kill_shard(self, index: int) -> Dict[str, int]:
        """Kill scheduler shard ``index``: its key range and open units
        reassign deterministically to the survivors (fail_shard)."""
        shards = self._need_shards()
        self._tick("fault")
        info = shards.fail_shard(index)
        self._log("kill_shard", (index, info))
        self._dump_fault("kill_shard")
        self.phase = "idle"
        return info

    def random_shard_kill(self) -> Optional[int]:
        """Kill a seeded-random alive shard (never the last one); -> the
        killed index, or None when only one shard survives."""
        shards = self._need_shards()
        alive = shards.alive_shards()
        if len(alive) < 2:
            return None
        index = int(alive[self.rng.integers(len(alive))])
        self.kill_shard(index)
        return index

    def add_shard(self) -> int:
        """A new scheduler shard joins the plane and takes its share of
        range slots from the most-loaded owners; -> its index."""
        shards = self._need_shards()
        self._tick("fault")
        index = shards.add_shard()
        self._log("add_shard", index)
        self._dump_fault("add_shard")
        self.phase = "idle"
        return index

    def split_hot_shard(self) -> Optional[int]:
        """Split the hottest alive shard (largest open backlog,
        deterministic index tie-break) into the least-loaded one; -> the
        split shard's index, or None when there is nothing worth
        splitting (single alive shard, empty backlog, or the hot shard
        owns a single slot)."""
        shards = self._need_shards()
        alive = shards.alive_shards()
        if len(alive) < 2:
            return None
        hot = max(alive,
                  key=lambda i: (shards.shards[i].open_backlog(), -i))
        owned = sum(1 for o in shards._range_owner if o == hot)
        if shards.shards[hot].open_backlog() == 0 or owned < 2:
            return None
        self._tick("fault")
        info = shards.split_shard(hot)
        self._log("split_shard", (hot, info))
        self._dump_fault("split_shard")
        self.phase = "idle"
        return hot

    def rejoin_shard(self, index: int) -> Dict[str, int]:
        """A previously killed shard returns empty and earns slots back
        from the most-loaded owners."""
        shards = self._need_shards()
        self._tick("fault")
        info = shards.rejoin_shard(index)
        self._log("rejoin_shard", (index, info))
        self._dump_fault("rejoin_shard")
        self.phase = "idle"
        return info

    # -- edge-cache churn --------------------------------------------------
    def _need_edges(self):
        if self.edges is None:
            raise RuntimeError("this step needs edges=; the sim was built "
                               "without an EdgeTier")
        return self.edges

    def kill_cache(self, index: int, wipe: bool = False) -> None:
        """Kill edge cache ``index``: it drops out of discovery rankings
        immediately; ``wipe`` simulates disk loss as well."""
        edges = self._need_edges()
        self._tick("fault")
        edges.mark_down(index)
        if wipe:
            edges.members[index].invalidate()
        self._log("kill_cache", (index, wipe))
        self._dump_fault("kill_cache")
        self.phase = "idle"

    def revive_cache(self, index: int, stale: bool = False) -> None:
        """Revive edge cache ``index``.  ``stale`` drops its contents
        first — the cache re-enters rankings at zero coverage and must
        demand-fill before serving (the stale-cache churn case)."""
        edges = self._need_edges()
        self._tick("fault")
        if stale:
            edges.members[index].invalidate()
        edges.mark_up(index)
        self._log("revive_cache", (index, stale))
        self._dump_fault("revive_cache")
        self.phase = "idle"

    def random_cache_kill(self) -> Optional[int]:
        """Kill a seeded-random alive edge cache; -> the killed index, or
        None when no cache is alive."""
        edges = self._need_edges()
        alive = edges.alive_indices()
        if not alive:
            return None
        index = int(alive[self.rng.integers(len(alive))])
        self.kill_cache(index)
        return index

    def settle(self, max_rounds: int = 32) -> None:
        """Pump + deliver until the outbox and the wire are both empty."""
        for _ in range(max_rounds):
            if not self.replicas.outbox and not self.in_flight:
                return
            self.pump()
            self.deliver(shuffle=False)

    # -- accounting --------------------------------------------------------
    def peer_ingests_during_hot_steps(self) -> List[tuple]:
        """Log entries where a *non-primary* member did ingest I/O inside a
        hot step.  Must be empty: the snapshot hot path only enqueues."""
        return [e for e in self.ingest_log
                if e[1] == "hot" and e[2] != e[3]]
