"""BaseDisk / DepDisk state partitioning (paper §III-C).

V-BOINC splits the VM over two VDI files: a minimal *fixed-size* base image
(FDI) and growable *dependency disks* (DDI) that are attached per project, so
switching projects only swaps the DepDisk.  Our analogue partitions training
state into namespaces with independent manifests and lifecycle:

* ``base``  — model parameters: fixed layout, content-addressed, shared by
  every task fine-tuning the same model (the "649 MB FDI").
* DepDisks  — optimizer state, task adapters (LoRA), KV caches: created
  empty ("fresh disk locally created"), grow chunk-on-write, attach/detach
  without touching the base.

Snapshot sizes are reported per-disk, reproducing Table II's separate
"DepDisk Snapshot Size" / "VM Snapshot Size" columns.  The diff runs where
each disk's state lies (the port's ``SnapshotManager`` has no delta mode),
and a disk restores onto a device instead of a mesh.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, Optional

from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.snapshots import Manifest, SnapshotInfo, SnapshotManager


@dataclass
class DiskInfo:
    name: str
    kind: str                   # base (FDI) | dep (DDI)
    attached: bool
    snapshots: int
    logical_bytes: int


class DiskSet:
    """A capsule's attached storage: one base disk + N dependency disks."""

    def __init__(self, store: ChunkStore, root=None, keep_last: int = 3,
                 async_mode: bool = False, writer_depth: int = 2):
        self.store = store
        self._managers: Dict[str, SnapshotManager] = {}
        self._kinds: Dict[str, str] = {}
        self._attached: Dict[str, bool] = {}
        self._root = root
        self._keep_last = keep_last
        self._async_mode = async_mode
        self._writer_depth = writer_depth

    # ------------------------------------------------------------------
    def _mgr(self, name: str) -> SnapshotManager:
        if name not in self._managers:
            sub = None if self._root is None else self._root / name
            # auto_gc off: the store is shared across disks, so only the
            # DiskSet-level mark (gc_all) may sweep it.
            self._managers[name] = SnapshotManager(
                self.store, root=sub, keep_last=self._keep_last,
                auto_gc=False, async_mode=self._async_mode,
                writer_depth=self._writer_depth)
        return self._managers[name]

    def create_base(self, params, *, step: int = 0) -> SnapshotInfo:
        """Register the fixed base image (model params)."""
        self._kinds["base"] = "base"
        self._attached["base"] = True
        return self._mgr("base").snapshot(params, step=step)

    def attach_dep(self, name: str, state: Any = None, *,
                   step: int = 0) -> Optional[SnapshotInfo]:
        """Attach a DepDisk; fresh (empty) if no state is given."""
        if name == "base":
            raise ValueError("'base' is reserved")
        self._kinds[name] = "dep"
        self._attached[name] = True
        if state is not None:
            return self._mgr(name).snapshot(state, step=step)
        return None

    def detach(self, name: str) -> None:
        """Detach (keeps snapshots — a re-attach later resumes the task)."""
        if not self._attached.get(name):
            raise KeyError(f"disk {name!r} not attached")
        self._attached[name] = False

    def snapshot_disk(self, name: str, state, *, step: int,
                      aux: Optional[dict] = None, block: bool = True):
        if not self._attached.get(name):
            raise KeyError(f"disk {name!r} not attached")
        res = self._mgr(name).snapshot(state, step=step, aux=aux,
                                       block=block)
        if block:
            self.gc_all()
        # non-blocking (async writer): sweeping here would stall the caller
        # on the gc lock the writer holds mid-commit — callers run
        # wait_all() + gc_all() off the hot path instead
        return res

    def wait_all(self) -> None:
        """Drain every disk's pending background writes."""
        for mgr in self._managers.values():
            mgr.wait()

    def close_all(self) -> None:
        for mgr in self._managers.values():
            mgr.close()

    def restore_disk(self, name: str, *, target_tree=None, device="cpu",
                     snapshot_id: Optional[str] = None):
        return self._mgr(name).restore(snapshot_id, target_tree=target_tree,
                                       device=device)

    def swap_task(self, old: str, new: str, state: Any = None):
        """Switch projects: detach one DepDisk, attach another — the base
        disk is untouched (no re-download of the 'VM image')."""
        if self._attached.get(old):
            self.detach(old)
        return self.attach_dep(new, state)

    # ------------------------------------------------------------------
    def disks(self) -> list[DiskInfo]:
        out = []
        for name, kind in self._kinds.items():
            mgr = self._managers.get(name)
            latest = mgr.manifests.get(mgr.latest()) if mgr and mgr.latest() \
                else None
            logical = 0
            if latest is not None:
                for ent in latest.tensors.values():
                    import numpy as np
                    n = 1
                    for d in ent.shape:
                        n *= d
                    logical += n * np.dtype(ent.dtype).itemsize
            out.append(DiskInfo(name, kind, self._attached.get(name, False),
                                len(mgr.order) if mgr else 0, logical))
        return out

    def gc_all(self) -> int:
        """Mark live refs across ALL disks (the store expands the closure
        over delta parents), sweep the shared store.

        Live-set collection and the sweep hold the store's ``gc_lock``
        together: with async writers a sibling disk's snapshot could
        commit between an unlocked mark and the sweep, and its
        just-written objects — absent from the stale live set — would be
        swept.  The lock is reentrant, so ``store.gc`` re-acquiring it
        inside is fine."""
        with self.store.gc_lock:
            live: set[str] = set()
            for mgr in self._managers.values():
                for man in mgr.manifests.values():
                    live.update(man.all_refs())
            return self.store.gc(live)
