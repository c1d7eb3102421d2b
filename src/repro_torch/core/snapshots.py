"""System-level checkpointing with device-resident differencing snapshots.

The SnapshotManager checkpoints the ENTIRE program state transparently —
params, optimizer moments, data cursor, RNG, step — so "project developers
omit application-level checkpointing from their code" (paper §III-E).
Mechanics mirror VirtualBox snapshots, but the diff is computed *before*
anything crosses the device→host boundary:

* ``snapshot()`` — the first snapshot is a full base image.  Every later
  one is a *differencing image*: the fused CUDA probe kernel
  (kernels/delta_encode) XORs the new state against a **device-resident
  mirror** of the previous snapshot (the slot keeps the new tiles after
  each diff, so no H→D re-upload), size-bucketed so the whole state diffs
  in a few concatenated launches.
  Only the changed tiles cross to host.  Unchanged store chunks re-use the
  parent manifest's refs with **no hashing at all**, and changed chunks
  are written as delta objects (``parent_ref + RLE XOR``) — snapshot cost
  is O(changed blocks), not O(state bytes).
* **Async writer** (``async_mode=True``) — the calling thread runs ONLY
  the device probe + changed-tile transfer (``probe_leaves``); chunk
  compaction, hashing, RLE, ``put_delta`` and deferred ``max_chain``
  rebase run on a background ``SnapshotWriter`` behind a bounded queue,
  so the trainer's stall is the probe and nothing else
  (``SnapshotInfo.stall_ms``; the write is the ``snapshot.write`` span
  on the writer's thread and the writer's ``write_ms``).  Plans are
  self-contained (they carry the changed tiles + bitmap, or the full base
  image); the writer keeps its OWN host image per tensor and advances it
  serially, so writer and planner share no mutable state.  A half-written
  snapshot stays invisible: the manifest registers only after every object
  landed, and a write failure poisons the queue — the next snapshot
  re-bases from a fresh base image, exactly the ``_mirror.clear()``
  invariant of the inline path.
* **Manifest v2** — each ``TensorEntry`` records per-block refs that are
  either raw hashes or ``"d:"`` delta refs.  v1 manifests (``hashes``)
  remain readable, so old snapshot directories restore unchanged.
* ``restore(sid)`` — resolve each ref through its base chain
  (``ChunkStore.resolve``) and rebuild the state on a device; chains are
  bounded by the store's ``max_chain`` (deep chains rebase automatically).
* ``delete/gc`` — mark the *closure* of live refs from retained
  snapshots (a delta keeps its parents alive), sweep the rest.  The mark
  and the sweep hold the store's ``gc_lock`` so a concurrent background
  write can never have a just-written, not-yet-committed object swept.

Manifests are the reference's, key for key and byte for byte: leaves are
flattened in ``jax.tree_util`` order under ``keystr`` paths and dtypes are
recorded by their numpy names, so either framework restores the other's
chain from the shared on-disk store.
"""
from __future__ import annotations

import contextlib
import json
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core import telemetry as tlm
from repro_torch.core.chunkstore import ChunkStore, sha256
from repro_torch.core.writer import SnapshotWriter
from repro_torch.kernels.delta_encode.ops import (DeviceMirror,
                                                  chunk_records,
                                                  dtype_from_name,
                                                  dtype_name, probe_leaves)

MANIFEST_VERSION = 2


def _flatten(tree) -> list[tuple[str, Any]]:
    return tu.flatten_with_keys(tree)


def _host_bytes(leaf: torch.Tensor) -> np.ndarray:
    """Flat uint8 host copy of a leaf's bytes (never aliases the leaf)."""
    flat = leaf.detach().reshape(-1).view(torch.uint8)
    host = flat.cpu().numpy()
    return host.copy() if flat.device.type == "cpu" else host


def _from_bytes(data: bytes, shape, dtype: str, device) -> torch.Tensor:
    """Tensor of ``shape``/``dtype`` from raw little-endian bytes."""
    dt = dtype_from_name(dtype)
    t = torch.frombuffer(bytearray(data), dtype=torch.uint8) if data \
        else torch.empty(0, dtype=torch.uint8)
    return t.view(dt).reshape(tuple(shape)).to(device)


@dataclass
class TensorEntry:
    shape: tuple
    dtype: str
    refs: List[str]           # per-block: raw sha256 hex | "d:" delta ref

    # v1 manifests named this field "hashes"; keep the alias for callers
    @property
    def hashes(self) -> List[str]:
        return self.refs

    def to_json(self):
        return {"shape": list(self.shape), "dtype": self.dtype,
                "refs": self.refs}

    @classmethod
    def from_json(cls, d):
        return cls(tuple(d["shape"]), d["dtype"],
                   list(d.get("refs", d.get("hashes", []))))


@dataclass
class Manifest:
    snapshot_id: str
    parent: Optional[str]
    step: int
    created: float
    tensors: Dict[str, TensorEntry]
    aux: dict = field(default_factory=dict)      # cursor, rng seed, metrics
    kind: str = "diff"                            # base | diff
    version: int = MANIFEST_VERSION

    def all_refs(self) -> List[str]:
        return [r for ent in self.tensors.values() for r in ent.refs]

    def to_json(self) -> str:
        return json.dumps({
            "version": self.version,
            "snapshot_id": self.snapshot_id, "parent": self.parent,
            "step": self.step, "created": self.created, "kind": self.kind,
            "aux": self.aux,
            "tensors": {k: t.to_json() for k, t in self.tensors.items()},
        })

    @classmethod
    def from_json(cls, s: str) -> "Manifest":
        d = json.loads(s)
        return cls(d["snapshot_id"], d["parent"], d["step"], d["created"],
                   {k: TensorEntry.from_json(t)
                    for k, t in d["tensors"].items()},
                   d.get("aux", {}), d.get("kind", "diff"),
                   d.get("version", 1))


@dataclass
class SnapshotInfo:
    snapshot_id: str
    step: int
    kind: str
    wall_s: float
    new_bytes: int        # differencing-image cost (changed blocks)
    dedup_bytes: int      # blocks reused from the chain
    total_bytes: int      # logical state size
    changed_chunks: int = 0
    reused_chunks: int = 0
    stall_ms: float = 0.0     # trainer-visible time (plan [+ write inline])
    plan_ms: float = 0.0      # device probe + changed-tile transfer


@dataclass
class _TensorPlan:
    """Per-tensor work captured synchronously at snapshot() time.

    Self-contained: either the full host image (``base``, re-base path) or
    the probe's compacted changed tiles + bitmap (delta path).  The writer
    folds tiles into its OWN host image (``SnapshotManager._mirror``, which
    only the writer advances), so planner and writer share no mutable
    state and the planner never touches host chunk layout at all."""
    key: str
    shape: tuple
    dtype: str
    nbytes: int
    base: Optional[np.ndarray] = None        # full host image (base path)
    tiles: Optional[np.ndarray] = None       # compacted changed 32 KiB tiles
    bitmap: Optional[np.ndarray] = None      # per-tile changed flags


class SnapshotManager:
    def __init__(self, store: ChunkStore,
                 root: Optional[Path] = None,
                 keep_last: int = 3,
                 async_mode: bool = False,
                 writer_depth: int = 2,
                 auto_gc: bool = True,
                 delta: bool = True,
                 telemetry=None):
        self.store = store
        self.tel = tlm.resolve(telemetry)    # spans snapshot.plan, .write
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            (self.root / "manifests").mkdir(parents=True, exist_ok=True)
        self.keep_last = keep_last
        # when the store is SHARED across managers (DiskSet), per-manager
        # sweeps would delete sibling disks' chunks — the owner must run a
        # global mark (DiskSet.gc_all) instead.
        self.auto_gc = auto_gc
        # delta=False falls back to the v1 full-hash path (every snapshot
        # re-hashes every chunk).  The diff runs where the state lives: the
        # CUDA kernel for tensors on the card, its plain version on the CPU.
        self.delta = delta
        self.manifests: Dict[str, Manifest] = {}
        self.order: List[str] = []                 # snapshot chain
        self._writer = SnapshotWriter(self._write_bg, depth=writer_depth,
                                      telemetry=self.tel) \
            if async_mode else None
        self._futures: deque[Future] = deque()
        self.last_info: Optional[SnapshotInfo] = None
        self._counter = 0
        # host byte image per tensor, advanced ONLY by the write path
        # (writer thread in async mode) — the probing thread never reads it
        self._mirror: Dict[str, np.ndarray] = {}
        self._device_mirror = DeviceMirror()       # probe-side tiles (no H→D)
        self._prev_refs: Dict[str, List[str]] = {}

    @property
    def is_async(self) -> bool:
        return self._writer is not None

    @property
    def writer_stats(self) -> dict:
        return dict(self._writer.stats) if self._writer is not None else {}

    # ------------------------------------------------------------------
    def snapshot(self, state, *, step: int, aux: Optional[dict] = None,
                 block: bool = True) -> SnapshotInfo | Future:
        """Take a snapshot.  ``state`` is any nested container of tensors.

        Planning (device probe + changed-tile transfer) is synchronous;
        with ``async_mode`` chunk compaction and the store/manifest writes
        run on the background writer and ``block=False`` returns the
        write's Future immediately — the caller's stall is the probe plus
        queue backpressure, nothing else."""
        self._reap()             # surface any finished/failed async write
        t0 = time.time()
        tp = time.perf_counter()
        try:
            with self.tel.span("snapshot.plan"):
                plan = self._plan_state(state)
        except BaseException:
            # a partial plan has already advanced some tensors' mirrors
            # while _prev_refs still points at the old chunks; drop both so
            # the next snapshot re-bases instead of recording stale refs
            self._poison()
            raise
        plan_ms = (time.perf_counter() - tp) * 1e3
        if self._writer is not None:
            try:
                fut = self._writer.submit(plan, step, aux or {}, t0, plan_ms)
            except BaseException:
                self._poison()
                raise
            self._futures.append(fut)
            return self.wait() if block else fut
        return self._write_sync(plan, step, aux or {}, t0, plan_ms)

    def wait(self) -> Optional[SnapshotInfo]:
        """Drain pending background writes; returns the last SnapshotInfo.
        Raises (once) if any pending write failed, after re-basing."""
        out = self.last_info if self._futures else None
        try:
            while self._futures:
                out = self._futures.popleft().result()
                self.last_info = out
        except BaseException:
            self._poison()
            raise
        return out

    def close(self) -> None:
        """Drain the writer and stop its thread."""
        try:
            self.wait()
        finally:
            if self._writer is not None:
                self._writer.close()

    def _reap(self) -> None:
        """Non-blocking: collect already-finished async writes (keeps the
        future list bounded and surfaces failures at the next snapshot)."""
        while self._futures and self._futures[0].done():
            fut = self._futures.popleft()
            try:
                self.last_info = fut.result()
            except BaseException:
                self._poison()
                raise

    def _poison(self) -> None:
        """Re-base after a failure: drain valid queued writes, then drop
        every mirror so the next snapshot records a full base image rather
        than delta refs against parents that never landed."""
        if self._writer is not None:
            while self._futures:
                fut = self._futures.popleft()
                with contextlib.suppress(BaseException):
                    self.last_info = fut.result()
            self._writer.reset()
        self._mirror.clear()
        self._device_mirror.clear()
        self._prev_refs.clear()

    # ------------------------------------------------------------------
    def _plan_state(self, state) -> List[_TensorPlan]:
        """Probe the whole state in size-bucketed fused launches against
        the device-resident mirror slots — this is ALL the work the
        calling thread does per tensor.  Leaves the probe reports as
        un-probed (first snapshot, shape/dtype change, bucket membership
        change) fall back to full base images; the probe seeded their
        slots, so the next round diffs them."""
        # detach only what tracks grad: a fresh detached object per call
        # would defeat the probe's same-tensor skip
        flat = [(k, leaf.detach() if leaf.requires_grad else leaf)
                for k, leaf in _flatten(state)]
        probes = {}
        if self.delta and flat:
            probes = probe_leaves(dict(flat), mirror=self._device_mirror)
        plans = []
        for key, leaf in flat:
            pr = probes.get(key)
            if pr is None:
                plans.append(self._plan_base(key, leaf))
            else:
                tiles, bitmap, nbytes = pr
                plans.append(_TensorPlan(key, tuple(leaf.shape),
                                         dtype_name(leaf.dtype), nbytes,
                                         tiles=tiles, bitmap=bitmap))
        return plans

    def _plan_base(self, key: str, leaf: torch.Tensor) -> _TensorPlan:
        host = _host_bytes(leaf)     # plan must not alias caller data
        return _TensorPlan(key, tuple(leaf.shape), dtype_name(leaf.dtype),
                           host.nbytes, base=host)

    # ------------------------------------------------------------------
    def _write_sync(self, plan, step, aux, t0, plan_ms) -> SnapshotInfo:
        try:
            with self.tel.span("snapshot.write"):
                info = self._write_inner(plan, step, aux, t0)
        except BaseException:
            # the probe already swapped the device mirror forward; a
            # half-written store would make the NEXT diff record stale
            # parent refs.  Drop the mirrors so the next snapshot is a
            # full base image.
            self._poison()
            raise
        info.plan_ms = plan_ms
        info.stall_ms = info.wall_s * 1e3    # inline: the trainer paid it all
        self.last_info = info
        return info

    def _write_bg(self, plan, step, aux, t0, plan_ms) -> SnapshotInfo:
        with self.tel.span("snapshot.write"):
            info = self._write_inner(plan, step, aux, t0)
        info.plan_ms = plan_ms
        info.stall_ms = plan_ms              # trainer paid only the plan
        return info

    def _write_inner(self, plan: List[_TensorPlan], step: int, aux: dict,
                     t0: float) -> SnapshotInfo:
        before_put = self.store.stats["put_bytes"]
        before_dedup = self.store.stats["dedup_bytes"]
        cb = self.store.chunk_bytes
        tensors = {}
        total = changed = reused = reused_bytes = 0
        # hold the store's gc lock across write + manifest commit so a
        # concurrent mark/sweep can never see (and sweep) this snapshot's
        # objects while its manifest is still unregistered
        with self._gc_guard():
            for p in plan:
                total += p.nbytes
                if p.base is not None:
                    flat = np.asarray(p.base).reshape(-1).view(np.uint8)
                    refs = self.store.put_buffer(memoryview(flat))
                    changed += len(refs)
                    self._mirror[p.key] = flat
                else:
                    # fold the probe's tiles into the writer's host image
                    # and derive per-chunk XOR records — off the hot path
                    prev_refs = self._prev_refs[p.key]
                    records: Dict[int, bytes] = {}
                    new_flat = None
                    if p.bitmap is not None and p.bitmap.any():
                        records, new_flat = chunk_records(
                            self._mirror[p.key], p.tiles, p.bitmap,
                            p.nbytes, cb)
                    refs = []
                    for ci, pref in enumerate(prev_refs):
                        xor = records.get(ci)
                        if xor is None:
                            refs.append(pref)
                            reused += 1
                            reused_bytes += max(
                                0, min((ci + 1) * cb, p.nbytes) - ci * cb)
                        else:
                            cs = ci * cb
                            ce = min(cs + cb, p.nbytes)
                            refs.append(self.store.put_delta(
                                pref, xor,
                                full_bytes=new_flat[cs:ce].tobytes()))
                            changed += 1
                    if new_flat is not None:
                        self._mirror[p.key] = new_flat
                tensors[p.key] = TensorEntry(p.shape, p.dtype, refs)
                self._prev_refs[p.key] = refs
            # chain reuse counts as dedup, as the v1 hash-everything path did
            self.store.metrics.dedup_bytes.inc(reused_bytes)
            self.store.metrics.dedup_chunks.inc(reused)
            self._counter += 1
            sid = f"snap-{self._counter:06d}-{sha256(str(step).encode())[:8]}"
            parent = self.order[-1] if self.order else None
            man = Manifest(sid, parent, step, time.time(), tensors, aux,
                           kind="base" if parent is None else "diff")
            self.manifests[sid] = man
            self.order.append(sid)
            if self.root is not None:
                (self.root / "manifests" / f"{sid}.json") \
                    .write_text(man.to_json())
        self.gc() if self.auto_gc else self._trim_manifests()
        return SnapshotInfo(
            snapshot_id=sid, step=step, kind=man.kind,
            wall_s=time.time() - t0,
            new_bytes=self.store.stats["put_bytes"] - before_put,
            dedup_bytes=self.store.stats["dedup_bytes"] - before_dedup,
            total_bytes=total,
            changed_chunks=changed, reused_chunks=reused)

    def _gc_guard(self):
        lock = getattr(self.store, "gc_lock", None)
        return lock if lock is not None else contextlib.nullcontext()

    # ------------------------------------------------------------------
    def restore(self, snapshot_id: Optional[str] = None, *,
                target_tree=None, device="cpu", rules=None):
        """Rebuild state on ``device`` (optionally re-sharded onto a mesh).

        Returns (state, aux).  ``target_tree`` supplies the structure (any
        tree with the state's layout, e.g. ``api.state_specs(cfg)``);
        flattened key paths must match the manifest.  Without it the state
        comes back as {keystr path: tensor}.  With ``rules`` (a
        ``ShardingRules``; ``target_tree`` then a ``TensorSpec`` tree) each
        leaf is distributed to its placements on the rules' mesh, whatever
        mesh, if any, the snapshot was taken on (``device`` the mesh's).
        Handles v2 (delta-ref) and v1 (hash-list) manifests alike;
        bfloat16 leaves are rebuilt from their raw bytes, with no numpy
        bfloat16 type needed.
        """
        self.wait()
        sid = snapshot_id or (self.order[-1] if self.order else None)
        if sid is None:
            raise ValueError("no snapshots available")
        man = self.get_manifest(sid)
        arrays = {key: _from_bytes(self.store.resolve_buffer(ent.refs),
                                   ent.shape, ent.dtype, device)
                  for key, ent in man.tensors.items()}
        if target_tree is None:
            return arrays, man.aux
        if rules is not None:
            arrays = {key: rules.distribute(arrays[key], spec) for key, spec
                      in tu.flatten_with_keys(target_tree)}
        return tu.unflatten_like(target_tree, arrays), man.aux

    def load_existing(self) -> int:
        """Adopt manifests already on disk under ``root`` (a previous
        process's chain) into this manager's order.

        Ordered by ``(step, created)``, NOT filename: snapshot ids restart
        per process, so a resumed run's newest snapshot can sort first by
        name.  v1 (``hashes``) and v2 (``refs``) manifests mix freely in
        one directory.  Returns the number of manifests adopted."""
        if self.root is None:
            raise ValueError("load_existing needs an on-disk root")
        mans = [Manifest.from_json(p.read_text())
                for p in sorted((self.root / "manifests").glob("*.json"))]
        adopted = 0
        for man in sorted(mans, key=lambda m: (m.step, m.created)):
            if man.snapshot_id in self.manifests:
                continue
            self.manifests[man.snapshot_id] = man
            self.order.append(man.snapshot_id)
            adopted += 1
        # new snapshots must not reuse an adopted id slot
        self._counter = max(self._counter, len(self.order))
        return adopted

    def get_manifest(self, sid: str) -> Manifest:
        """In-memory manifest, falling back to the on-disk copy."""
        man = self.manifests.get(sid)
        return man if man is not None else self._load_manifest(sid)

    def _load_manifest(self, sid: str) -> Manifest:
        if self.root is None:
            raise KeyError(sid)
        man = Manifest.from_json(
            (self.root / "manifests" / f"{sid}.json").read_text())
        self.manifests[sid] = man
        return man

    # ------------------------------------------------------------------
    def download_plan(self, client_refs: set[str],
                      snapshot_id: Optional[str] = None):
        """Block-level transfer accounting for a re-attaching volunteer.

        -> (missing refs, bytes to move, bytes saved) for the given (or
        latest) snapshot — the same ``ChunkStore.plan_send`` (Wire) the
        server's ``fetch_capsule`` uses."""
        self.wait()
        sid = snapshot_id or (self.order[-1] if self.order else None)
        if sid is None:
            raise ValueError("no snapshots available")
        return self.store.plan_send(self.get_manifest(sid).all_refs(),
                                    client_refs)

    # ------------------------------------------------------------------
    def _trim_manifests(self) -> None:
        while len(self.order) > self.keep_last:
            sid = self.order.pop(0)
            man = self.manifests.pop(sid, None)
            if man is not None and self.root is not None:
                p = self.root / "manifests" / f"{sid}.json"
                if p.exists():
                    p.unlink()

    def gc(self) -> int:
        """Keep the last ``keep_last`` snapshots; mark the closure of their
        refs (delta parents stay live) and sweep the store.  Mark + sweep
        run under the store's gc lock so an in-flight background write
        commits its manifest before the live set is collected."""
        with self._gc_guard():
            self._trim_manifests()
            live: set[str] = set()
            for man in self.manifests.values():
                live.update(man.all_refs())
            return self.store.gc(live)

    def latest(self) -> Optional[str]:
        return self.order[-1] if self.order else None
