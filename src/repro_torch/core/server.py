"""V-BOINC project server (paper Fig. 1 flow).

Distributes *capsules* ("VM images") instead of scientific applications, and
answers DepDisk probes: the V-BOINC client asks whether a project has
dependencies (1.1), downloads the DepDisk if so, otherwise creates a fresh
one locally (3).  Transfer accounting reproduces the paper's bandwidth story
(207 MB compressed image / ~3 min at 9 Mbps → bytes-moved metrics here):
``fetch_capsule`` runs the same block-level ``plan_send`` (Wire) dedup as a
volunteer's restore, so a re-attaching client moves only the missing blocks
— typically just the delta objects written since it detached.  With an
``EdgeTier`` attached (``attach_edge``), fetches route through the edge
discovery service and drain from delta caches instead of this store.
"""
from __future__ import annotations

import hashlib
import json
from dataclasses import dataclass, field
from typing import Dict, Optional

from repro_torch.core import telemetry as tlm
from repro_torch.core.capsule import CapsuleSpec
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.scheduler import VolunteerScheduler
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.core.uplink import UplinkUpdate, decode_update, push_update


@dataclass
class Project:
    name: str
    capsule: CapsuleSpec
    dep_manifest: Optional[dict] = None      # None = no dependencies
    scheduler: VolunteerScheduler = field(
        default_factory=VolunteerScheduler)
    # attached snapshot chain: a re-attaching volunteer syncs its state
    # blocks through the same fetch path as the capsule itself
    snapshots: Optional[SnapshotManager] = None
    # delta-aware uplink: per-unit updates as they arrive, and the fold of
    # the quorum winner (unit id -> the canonical worker's UplinkUpdate)
    uplink_results: Dict[int, Dict[str, UplinkUpdate]] = field(
        default_factory=dict)
    canonical_updates: Dict[int, UplinkUpdate] = field(default_factory=dict)


@dataclass
class TransferLog:
    bytes_out: int = 0
    bytes_dedup: int = 0
    requests: int = 0
    # route -> serve count ("origin", "dedup", or an edge-cache id) when
    # an edge tier is attached; empty otherwise
    routes: Dict[str, int] = field(default_factory=dict)


@dataclass
class UplinkLog:
    bytes_in: int = 0
    bytes_dedup: int = 0
    accepted: int = 0
    rejected: int = 0


class VBoincServer:
    """Registry + distribution endpoint ("modified BOINC server")."""

    def __init__(self, store: ChunkStore, *,
                 telemetry: Optional[tlm.Telemetry] = None,
                 edge=None):
        self.store = store
        self.tel = tlm.resolve(telemetry)
        self.projects: Dict[str, Project] = {}
        self.transfers: Dict[str, TransferLog] = {}
        self.uplinks: Dict[str, UplinkLog] = {}   # per-project uplink log
        self.account_keys: Dict[str, str] = {}    # weak account keys
        self.edge = None
        if edge is not None:
            self.attach_edge(edge)

    def attach_edge(self, edge) -> None:
        """Front capsule distribution with an ``EdgeTier``: every
        ``fetch_capsule`` routes through its discovery service, so cold
        re-attach waves drain from the caches instead of this store."""
        if edge.origin is not self.store:
            raise ValueError("edge tier must front the server's chunk store")
        self.edge = edge

    def publish(self, project: Project) -> None:
        # fetch_capsule resolves snapshot refs against the SERVER's store
        if (project.snapshots is not None
                and project.snapshots.store is not self.store):
            raise ValueError("project snapshot manager must share the "
                             "server's chunk store")
        # store the capsule manifest as a chunk: its content hash IS the
        # spec's manifest_hash, so capsule distribution rides the same
        # block-level dedup accounting as snapshot state
        self.store.put(json.dumps(project.capsule.manifest(), sort_keys=True,
                                  default=str).encode())
        self.projects[project.name] = project

    def register_user(self, user: str) -> str:
        # derive from sha256, NOT Python's salted hash(): account keys must
        # be stable across server restarts (PYTHONHASHSEED)
        key = f"weak-{hashlib.sha256(user.encode()).hexdigest()[:8]}"
        self.account_keys[user] = key
        return key

    # ---- Fig. 1 steps -------------------------------------------------
    def probe_dependencies(self, project: str) -> Optional[dict]:
        """(1.1) does the project need a DepDisk?"""
        return self.projects[project].dep_manifest

    def fetch_capsule(self, project: str, client_hashes: set[str],
                      account_key: str) -> tuple[CapsuleSpec, list[str], int]:
        """(2) download the capsule; only blocks the client lacks move.

        Returns (spec, missing refs, bytes transferred).  The needed set is
        the capsule manifest plus the project's latest snapshot blocks (when
        a snapshot chain is attached), expanded over delta parents — the
        same ``ChunkStore.plan_send`` (Wire) accounting a volunteer's
        ``restore_latest`` uses, so a re-attaching client downloads only the
        delta objects written since it detached.  With an edge tier
        attached the fetch routes through discovery (``TransferLog.routes``
        records who served it); the plan — and therefore the restored
        bytes — is identical either way."""
        if account_key not in self.account_keys.values():
            raise PermissionError("unknown account key")
        proj = self.projects[project]
        log = self.transfers.setdefault(project, TransferLog())
        log.requests += 1
        needed = [proj.capsule.manifest_hash]
        if proj.snapshots is not None and proj.snapshots.latest():
            man = proj.snapshots.get_manifest(proj.snapshots.latest())
            needed += man.all_refs()
        if self.edge is not None:
            res = self.edge.fetch(needed, client_hashes)
            missing, moved, dedup = res.missing, res.bytes_moved, \
                res.bytes_dedup
            log.routes[res.route] = log.routes.get(res.route, 0) + 1
        else:
            missing, moved, dedup = self.store.plan_send(needed,
                                                         client_hashes)
        log.bytes_out += moved
        log.bytes_dedup += dedup
        return proj.capsule, missing, moved

    def request_work(self, project: str, worker_id: str):
        """(5)/(6) the inner client pulls jobs straight from the server."""
        return self.projects[project].scheduler.request_work(worker_id)

    def report_result(self, project: str, worker_id: str, unit_id: int,
                      result_hash: str,
                      update: Optional[UplinkUpdate] = None) -> bool:
        """(7) results go back directly; server-side quorum validation.

        With ``update`` the volunteer streams its quantized gradient/state
        delta through the chunk store instead of reporting a bare hash:
        only objects the server lacks move up (``plan_recv``), every
        record is re-hashed, and the full chain is resolved before the
        result counts — a corrupt or dangling upload is rejected without
        touching the scheduler.  When the unit's quorum is met, the
        canonical worker's refs are folded into the project's round state
        (``canonical_updates``), which ``resolve_round_update`` serves."""
        proj = self.projects[project]
        if update is not None and not self._ingest_update(
                proj, worker_id, unit_id, update):
            return False
        accepted = proj.scheduler.report(worker_id, unit_id, result_hash)
        # fold every unit whose quorum is now met — with a batched
        # scheduler (ShardedScheduler) a unit may complete at a *later*
        # round flush than the report that supplied the quorum result, so
        # folding keys off unit.completed, not this call's return value
        if proj.uplink_results:
            self._fold_ready(proj)
        return accepted

    def _ingest_update(self, proj: Project, worker_id: str, unit_id: int,
                       update: UplinkUpdate) -> bool:
        log = self.uplinks.setdefault(proj.name, UplinkLog())
        try:
            moved, dedup = push_update(update, self.store,
                                       client_id=worker_id)
        except (IOError, KeyError):
            log.rejected += 1
            return False
        try:
            decode_update(self.store, update)    # chain must fully resolve
        except (IOError, KeyError):
            # records landed (content-addressed, so harmless) but the
            # update is undecodable — claw back the per-client accounting
            # so the worker earns no transfer credit for a rejected result
            clog = self.store.uplinks[worker_id]
            clog["bytes_in"] -= moved
            clog["bytes_dedup"] -= dedup
            clog["rejected"] += 1
            log.rejected += 1
            return False
        log.bytes_in += moved
        log.bytes_dedup += dedup
        log.accepted += 1
        proj.uplink_results.setdefault(unit_id, {})[worker_id] = update
        self._prune(proj.uplink_results)
        return True

    # retained folded rounds: enough for any validator/re-attach window,
    # bounded so long trainings don't accumulate every round ever folded
    UPLINK_KEEP = 256

    def _prune(self, d: Dict[int, object]) -> None:
        while len(d) > self.UPLINK_KEEP:      # oldest unit ids first
            d.pop(next(iter(d)))

    def _fold_ready(self, proj: Project) -> None:
        """Fold canonical updates for every completed unit still holding
        replica uploads (bounded by UPLINK_KEEP)."""
        for uid in list(proj.uplink_results):
            unit = proj.scheduler.units.get(uid)
            if unit is not None and unit.completed:
                self._fold_canonical(proj, uid)

    def _fold_canonical(self, proj: Project, unit_id: int) -> None:
        unit = proj.scheduler.units.get(unit_id)
        ups = proj.uplink_results.get(unit_id, {})
        if unit is None or unit.canonical is None:
            return
        for wid, h in unit.results.items():
            if h == unit.canonical and wid in ups:
                proj.canonical_updates[unit_id] = ups[wid]
                proj.uplink_results.pop(unit_id)   # replicas folded; drop
                self._prune(proj.canonical_updates)
                if self.tel.tracing:
                    self.tel.event("uplink_fold", unit=unit_id, worker=wid)
                break

    def resolve_round_update(self, project: str, unit_id: int):
        """Fold a validated unit's delta refs into quantized leaves.

        -> {keypath: Compressed} resolved against the SERVER's store — the
        canonical round state the uplink reconstructs, proving the server
        no longer depends on the volunteer re-shipping full gradients."""
        proj = self.projects[project]
        self._fold_ready(proj)      # batched schedulers fold lazily
        update = proj.canonical_updates[unit_id]
        return decode_update(self.store, update)

    # ---- replica failover ---------------------------------------------
    def failover(self, index: Optional[int] = None) -> int:
        """Primary store loss: mark it down and promote a replica so
        ``fetch_capsule``/``report_result`` keep serving.

        Requires the server's store to be a ``ReplicaSet``.  Promotes the
        designated member ``index``, or the best-stocked alive replica when
        omitted.  Returns the promoted member index — every registry,
        scheduler and uplink table is untouched; only the object reads and
        writes move to the survivor."""
        store = self.store
        if not hasattr(store, "promote_best"):
            raise RuntimeError("failover needs a replicated store "
                               "(ReplicaSet); this server has a single "
                               "ChunkStore")
        old = store.primary_index
        store.mark_down(old)
        try:
            if index is None:
                promoted = store.promote_best()
            else:
                store.promote(index)
                promoted = index
        except (IndexError, ValueError, IOError):
            store.mark_up(old)     # bad target must not brick the primary
            raise
        if self.tel.tracing:
            self.tel.event("failover", old=old, promoted=promoted)
        return promoted

    def fail_shard(self, project: str, index: int) -> Dict[str, int]:
        """Scheduler-shard loss: reassign the dead shard's key range and
        open units to the survivors (the control-plane analogue of store
        ``failover``).  Requires the project's scheduler to be a
        ``ShardedScheduler``."""
        sched = self.projects[project].scheduler
        if not hasattr(sched, "fail_shard"):
            raise RuntimeError("fail_shard needs a sharded scheduler "
                               "(ShardedScheduler); this project runs a "
                               "single VolunteerScheduler")
        return sched.fail_shard(index)

    def scheduler_stats(self, project: str) -> Dict[str, int]:
        """Aggregated scheduler counters (plus per-shard totals when the
        project's scheduler is sharded)."""
        return dict(self.projects[project].scheduler.stats)

    # ---- §IV-C capacity -----------------------------------------------
    def tasks_per_day_capacity(self, dispatch_us: float,
                               validate_us: float) -> float:
        """Derived server capacity from measured per-op costs."""
        per_task_s = (dispatch_us + validate_us) / 1e6
        return 86_400.0 / per_task_s
