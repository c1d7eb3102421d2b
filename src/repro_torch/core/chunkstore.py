"""Content-addressed chunk store with raw and *delta* objects.

The substrate for differencing snapshots (paper §III-E).  Two object
kinds live side by side:

* **raw**   — chunk bytes, addressed by ``sha256(bytes)`` (refs are bare
  hex, as in v1 manifests);
* **delta** — ``parent_ref + zero-run-RLE-compressed XOR payload``,
  addressed as ``"d:" + sha256(record)``.  The analogue of a VirtualBox
  differencing image: a block written after a snapshot stores only its
  XOR against the parent block, so incremental cost is exactly the
  changed bytes (the paper's Table II behaviour by construction).

Delta records carry their chain depth; ``put_delta`` transparently
*rebases* — materializes a fresh raw object — when the chain would exceed
``max_chain`` (bounding restore cost) or when the encoded delta would be
no smaller than the chunk itself.  ``resolve`` reconstructs any ref: XOR
is associative, so a chain folds into the root base in one pass.  GC
marks the *closure* of live refs (a delta keeps its parents alive even
when the parent's manifest has been trimmed).

Integrity = re-hash on read for both kinds (the paper's "trusted
application" concern: a volunteer can verify every byte it receives).

Every transfer in the system — capsule/snapshot downlink, volunteer
uplink, replica fan-out and edge-cache demand-fill — speaks one **Wire**
protocol of four verbs:

* ``plan_send(refs, peer_has)`` — source-side planning: which of
  ``refs``'s delta closure a peer holding ``peer_has`` still needs, sized
  from this store's own objects (-> :class:`TransferPlan`);
* ``plan_recv(offered, client_id=)`` — sink-side planning: which of a
  client's offered objects this store lacks (sizes are the *client's*
  claim, for planning only — verified bytes accumulate in ``recv``);
* ``send(refs)`` — the wire image of objects: ref -> packed bytes (raw
  chunk bytes, or the packed delta record).  The receiver re-hashes
  everything, so the wire needs no extra framing;
* ``recv(records, client_id=)`` — validate-and-store: every ref is
  recomputed from the record bytes and delta chains must land
  parents-first with truthful depths, or nothing is written.

The pre-Wire names (``transfer_plan``, ``ingest_plan``, ``ingest``,
``export_records``) remain as thin deprecated shims.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import struct
import threading
import time
import warnings
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Protocol, runtime_checkable

from repro_torch.core import telemetry as tlm

import numpy as np

DEFAULT_CHUNK_BYTES = 1 << 20  # 1 MiB
DELTA_PREFIX = "d:"
_DELTA_MAGIC = b"VBD1"


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def is_delta_ref(ref: str) -> bool:
    return ref.startswith(DELTA_PREFIX)


# -- zero-run RLE ----------------------------------------------------------
# XOR payloads of a partly-changed chunk are mostly zero; encode as a token
# stream of [tag u8][len u32] where tag 0 = zero run, tag 1 = literal run
# (+ bytes).  Runs shorter than 8 bytes are folded into literals so worst
# case stays near 1x; callers fall back to the uncompressed payload when
# RLE does not win.

_MIN_ZERO_RUN = 8


def rle_zero_encode(data: bytes) -> bytes:
    a = np.frombuffer(data, np.uint8)
    if a.size == 0:
        return b""
    nz = a != 0
    # bail before the per-run loop when RLE cannot win: mostly-nonzero
    # payloads, or so many short runs (dense interleaving, e.g. fp32
    # tensors where every low byte changed) that token overhead dominates.
    # The single-literal fallback is 5 bytes longer than the input, so
    # put_delta's "payload >= xor" check discards it in O(1).
    def _literal():
        return b"\x01" + struct.pack("<I", a.size) + data

    if int(np.count_nonzero(nz)) * 2 > a.size:
        return _literal()
    change = np.flatnonzero(np.diff(nz.view(np.int8))) + 1
    if change.size > a.size // 64:        # avg run < 64 B: not worth it
        return _literal()
    starts = np.concatenate(([0], change))
    ends = np.concatenate((change, [a.size]))
    out = bytearray()
    lit_start = None
    for s, e in zip(starts, ends):
        if not nz[s] and e - s >= _MIN_ZERO_RUN:
            if lit_start is not None:
                out += b"\x01" + struct.pack("<I", s - lit_start)
                out += data[lit_start:s]
                lit_start = None
            out += b"\x00" + struct.pack("<I", e - s)
        elif lit_start is None:
            lit_start = s
    if lit_start is not None:
        out += b"\x01" + struct.pack("<I", a.size - lit_start)
        out += data[lit_start:]
    return bytes(out)


def rle_zero_decode(payload: bytes, out_len: int) -> bytes:
    out = bytearray(out_len)
    pos = i = 0
    while i < len(payload):
        tag = payload[i]
        n = struct.unpack_from("<I", payload, i + 1)[0]
        i += 5
        if tag == 1:
            out[pos:pos + n] = payload[i:i + n]
            i += n
        pos += n
    return bytes(out)


def _xor_bytes(a: bytes, b: bytes) -> bytes:
    return (np.frombuffer(a, np.uint8) ^ np.frombuffer(b, np.uint8)).tobytes()


@dataclass
class DeltaRecord:
    parent: str
    depth: int
    raw_len: int
    payload: bytes            # XOR vs parent, possibly RLE-compressed
    compressed: bool

    def pack(self) -> bytes:
        p = self.parent.encode()
        return (_DELTA_MAGIC
                + struct.pack("<HIBH", self.depth, self.raw_len,
                              int(self.compressed), len(p))
                + p + self.payload)

    @classmethod
    def unpack(cls, rec: bytes) -> "DeltaRecord":
        if rec[:4] != _DELTA_MAGIC:
            raise IOError("not a delta record")
        depth, raw_len, comp, plen = struct.unpack_from("<HIBH", rec, 4)
        off = 4 + struct.calcsize("<HIBH")
        parent = rec[off:off + plen].decode()
        return cls(parent, depth, raw_len, rec[off + plen:], bool(comp))

    def xor(self) -> bytes:
        return (rle_zero_decode(self.payload, self.raw_len)
                if self.compressed else self.payload)


@dataclass
class TransferPlan:
    """One planned object transfer, in either direction, on the Wire.

    ``refs`` are the objects that must move, ``bytes_moved`` their wire
    size, ``bytes_dedup`` the bytes the receiving side already held (the
    dedup savings the credit accounting reports).  Unpacks as the legacy
    ``(missing, moved, dedup)`` triple so callers written against
    ``transfer_plan``/``ingest_plan`` keep working unchanged."""

    refs: List[str]
    bytes_moved: int
    bytes_dedup: int

    def _astuple(self) -> tuple:
        return (self.refs, self.bytes_moved, self.bytes_dedup)

    def __iter__(self):
        return iter(self._astuple())

    def __len__(self) -> int:
        return 3

    def __getitem__(self, i):
        return self._astuple()[i]

    def __bool__(self) -> bool:
        return bool(self.refs)


@runtime_checkable
class Wire(Protocol):
    """The unified transfer surface every object mover speaks.

    Implemented by :class:`ChunkStore`, proxied by ``ReplicaSet`` (writes
    enqueue for replication) and served at the edge by ``EdgeCache`` —
    downlink capsule fetch, uplink result ingest, replica ``pump`` and
    edge demand-fill are all ``plan_*`` + ``send`` + ``recv`` exchanges
    between two Wire endpoints."""

    def plan_send(self, refs: Iterable[str],
                  peer_has: set) -> "TransferPlan": ...

    def plan_recv(self, offered: Dict[str, int], *,
                  client_id: Optional[str] = None) -> "TransferPlan": ...

    def send(self, refs: Iterable[str]) -> Dict[str, bytes]: ...

    def recv(self, records: Dict[str, bytes], *,
             client_id: Optional[str] = None) -> int: ...


def _warn_wire(old: str, new: str) -> None:
    warnings.warn(f"{old} is deprecated; speak the Wire protocol "
                  f"({new}) instead", DeprecationWarning, stacklevel=3)


class ChunkStore:
    """Deduplicating raw+delta object store with closure-marking GC."""

    def __init__(self, root: Optional[os.PathLike] = None,
                 chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 max_chain: int = 8, *,
                 telemetry: Optional["tlm.Telemetry"] = None):
        self.chunk_bytes = int(chunk_bytes)
        self.max_chain = int(max_chain)
        self.root = Path(root) if root is not None else None
        if self.root is not None:
            (self.root / "objects").mkdir(parents=True, exist_ok=True)
            (self.root / "deltas").mkdir(parents=True, exist_ok=True)
        self._mem: Dict[str, bytes] = {}
        self._mem_delta: Dict[str, bytes] = {}
        self._depths: Dict[str, int] = {}        # delta ref -> chain depth
        self._lock = threading.Lock()
        # serializes mark+sweep against concurrent writers: a background
        # SnapshotWriter holds this across "write objects + commit manifest"
        # so a GC can never collect its live set between the two.  Reentrant
        # because gc() runs under a caller's guard (DiskSet.gc_all collects
        # live refs from many managers under the same lock).
        self.gc_lock = threading.RLock()
        # telemetry registry behind the historical dict shape: .stats is
        # a read-only live view, writes go through .metrics
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("chunkstore")
        self.metrics = scope.counters(
            "put_bytes", "dedup_bytes", "get_bytes", "put_chunks",
            "dedup_chunks", "delta_chunks", "rebased", "ingest_bytes",
            "ingest_dedup_bytes", "ingest_records", "egress_bytes")
        self.stats = scope.view()
        # per-client uplink accounting (client id -> counters); the server
        # credits volunteers by the deduped bytes they actually moved
        self.uplinks: Dict[str, Dict[str, int]] = {}

    # -- raw object layer --------------------------------------------------
    def _path(self, h: str) -> Path:
        return self.root / "objects" / h[:2] / h[2:]

    def _dpath(self, h: str) -> Path:
        return self.root / "deltas" / h[:2] / h[2:]

    def has(self, ref: str) -> bool:
        if is_delta_ref(ref):
            h = ref[len(DELTA_PREFIX):]
            if self.root is None:
                return h in self._mem_delta
            return h in self._mem_delta or self._dpath(h).exists()
        if self.root is None:
            return ref in self._mem
        return ref in self._mem or self._path(ref).exists()

    def put(self, data: bytes) -> str:
        h = sha256(data)
        with self._lock:
            if self.has(h):
                self.metrics.dedup_bytes.inc(len(data))
                self.metrics.dedup_chunks.inc()
                return h
            self.metrics.put_bytes.inc(len(data))
            self.metrics.put_chunks.inc()
            if self.tel.tracing:
                self.tel.event("put", ref=h[:16], bytes=len(data))
            if self.root is None:
                self._mem[h] = bytes(data)
            else:
                self._atomic_write(self._path(h), data)
        return h

    @staticmethod
    def _atomic_write(p: Path, data: bytes) -> None:
        """Crash-consistent publish: write a uniquely-named temp file in the
        same directory, then ``os.replace`` it into place.  A crash mid-write
        leaves only a ``*.tmp`` orphan (never a torn object under a valid
        ref); the pid suffix keeps concurrent writers from clobbering each
        other's temp files."""
        p.parent.mkdir(parents=True, exist_ok=True)
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        tmp.write_bytes(data)
        os.replace(tmp, p)

    def get(self, h: str) -> bytes:
        if self.root is None or h in self._mem:
            data = self._mem[h]
        else:
            data = self._path(h).read_bytes()
        if sha256(data) != h:  # integrity (sandbox/trust analogue)
            raise IOError(f"chunk {h[:12]} failed integrity check")
        self.metrics.get_bytes.inc(len(data))
        return data

    def delete(self, ref: str) -> None:
        with self._lock:
            if is_delta_ref(ref):
                h = ref[len(DELTA_PREFIX):]
                self._mem_delta.pop(h, None)
                self._depths.pop(ref, None)
                if self.root is not None and self._dpath(h).exists():
                    self._dpath(h).unlink()
                return
            self._mem.pop(ref, None)
            if self.root is not None:
                p = self._path(ref)
                if p.exists():
                    p.unlink()

    def all_refs(self) -> Iterable[str]:
        out = set(self._mem)
        out.update(DELTA_PREFIX + h for h in self._mem_delta)
        if self.root is not None:
            # *.tmp orphans from a crashed writer are not objects
            for sub in (self.root / "objects").glob("*/*"):
                if not sub.name.endswith(".tmp"):
                    out.add(sub.parent.name + sub.name)
            for sub in (self.root / "deltas").glob("*/*"):
                if not sub.name.endswith(".tmp"):
                    out.add(DELTA_PREFIX + sub.parent.name + sub.name)
        return out

    # kept for callers of the v1 API
    all_hashes = all_refs

    # -- delta object layer ------------------------------------------------
    def put_delta(self, parent_ref: str, xor_bytes: bytes, *,
                  full_bytes: Optional[bytes] = None) -> str:
        """Store one changed block as a delta against ``parent_ref``.

        Returns the new ref.  Transparently rebases to a raw object when
        the chain would exceed ``max_chain`` or the delta record would be
        no smaller than the chunk itself (``full_bytes``, when given,
        avoids a resolve to materialize the rebase)."""
        depth = self.ref_depth(parent_ref) + 1
        if depth > self.max_chain:
            full = full_bytes if full_bytes is not None else _xor_bytes(
                self.resolve(parent_ref), xor_bytes)
            self.metrics.rebased.inc()
            return self.put(full)
        payload = rle_zero_encode(xor_bytes)
        compressed = True
        if len(payload) >= len(xor_bytes):
            payload, compressed = xor_bytes, False
        rec = DeltaRecord(parent_ref, depth, len(xor_bytes), payload,
                          compressed).pack()
        if full_bytes is not None and len(rec) >= len(full_bytes):
            return self.put(full_bytes)   # delta no cheaper than a base
        return self._write_delta(sha256(rec), rec, depth)

    def _write_delta(self, h: str, rec: bytes, depth: int) -> str:
        """Store a packed delta record under its content hash."""
        ref = DELTA_PREFIX + h
        with self._lock:
            if self.has(ref):
                self.metrics.dedup_bytes.inc(len(rec))
                self.metrics.dedup_chunks.inc()
            else:
                self.metrics.put_bytes.inc(len(rec))
                self.metrics.put_chunks.inc()
                self.metrics.delta_chunks.inc()
                if self.tel.tracing:
                    self.tel.event("put", ref=ref[:16], bytes=len(rec),
                                   delta=True, depth=depth)
                if self.root is None:
                    self._mem_delta[h] = rec
                else:
                    self._atomic_write(self._dpath(h), rec)
        self._depths[ref] = depth
        return ref

    def _delta_bytes(self, h: str) -> bytes:
        if self.root is None or h in self._mem_delta:
            rec = self._mem_delta[h]
        else:
            rec = self._dpath(h).read_bytes()
        if sha256(rec) != h:
            raise IOError(f"delta {h[:12]} failed integrity check")
        return rec

    def _get_delta(self, ref: str) -> DeltaRecord:
        rec = self._delta_bytes(ref[len(DELTA_PREFIX):])
        self.metrics.get_bytes.inc(len(rec))
        return DeltaRecord.unpack(rec)

    def ref_depth(self, ref: str) -> int:
        """Chain depth of a ref (0 for raw objects)."""
        if not is_delta_ref(ref):
            return 0
        d = self._depths.get(ref)
        if d is None:
            d = self._get_delta(ref).depth
            self._depths[ref] = d
        return d

    def resolve(self, ref: str) -> bytes:
        """Reconstruct a block from its base chain (raw refs pass through)."""
        if not is_delta_ref(ref):
            return self.get(ref)
        acc: Optional[bytes] = None
        while is_delta_ref(ref):
            rec = self._get_delta(ref)
            xor = rec.xor()
            acc = xor if acc is None else _xor_bytes(acc, xor)
            ref = rec.parent
        return _xor_bytes(self.get(ref), acc)

    def object_size(self, ref: str) -> int:
        """Stored (on-wire) byte size of one object."""
        if not self.has(ref):
            raise KeyError(f"object {ref[:14]} not in store")
        if is_delta_ref(ref):
            h = ref[len(DELTA_PREFIX):]
            if h in self._mem_delta:
                return len(self._mem_delta[h])
            return self._dpath(h).stat().st_size
        if ref in self._mem:
            return len(self._mem[ref])
        return self._path(ref).stat().st_size

    # -- tensor layer ------------------------------------------------------
    def put_buffer(self, buf: memoryview) -> list[str]:
        """Chunk + store one tensor's bytes; returns the ref list."""
        buf = memoryview(buf).cast("B")
        return [self.put(bytes(buf[o:o + self.chunk_bytes]))
                for o in range(0, max(len(buf), 1), self.chunk_bytes)]

    def get_buffer(self, refs: list[str]) -> bytes:
        return b"".join(self.get(h) for h in refs)

    def resolve_buffer(self, refs: list[str]) -> bytes:
        """Like ``get_buffer`` but follows delta chains."""
        return b"".join(self.resolve(r) for r in refs)

    # -- dedup accounting / GC ---------------------------------------------
    def live_closure(self, refs: Iterable[str]) -> set[str]:
        """Expand refs over delta parents — everything needed to resolve."""
        seen: set[str] = set()
        stack = list(refs)
        while stack:
            r = stack.pop()
            if r in seen:
                continue
            seen.add(r)
            if is_delta_ref(r):
                stack.append(self._get_delta(r).parent)
        return seen

    # -- Wire: planning (both directions) ----------------------------------
    def plan_send(self, refs: Iterable[str],
                  peer_has: set[str]) -> TransferPlan:
        """Source-side Wire planning: block-level dedup accounting shared
        by capsule fetch, volunteer restore and edge prefetch.

        Which of ``refs``'s delta closure a peer holding ``peer_has``
        still needs, sized from this store.  A peer that already holds a
        delta's parents downloads only the delta record."""
        needed = self.live_closure(refs)
        missing = sorted(r for r in needed if r not in peer_has)
        moved = sum(self.object_size(r) for r in missing)
        dedup = sum(self.object_size(r) for r in needed if r in peer_has)
        return TransferPlan(missing, moved, dedup)

    def plan_recv(self, offered: Dict[str, int], *,
                  client_id: Optional[str] = None) -> TransferPlan:
        """Sink-side Wire planning: which of a client's offered objects
        this store still needs (the uplink mirror of ``plan_send``).

        ``offered`` maps ref -> wire size as measured by the *client's*
        store (this store cannot size objects it does not hold yet).  The
        moved figure is the client's claim and is for *planning only*;
        credit-bearing ``bytes_in`` accumulates in ``recv`` from bytes
        actually verified and written, so an inflated offer cannot mint
        credit.  Dedup is sized from this store's own copies (it holds
        them), so it is verified here."""
        needed = sorted(r for r in offered if not self.has(r))
        moved = sum(offered[r] for r in needed)
        dedup = sum(self.object_size(r) for r in offered if self.has(r))
        self.metrics.ingest_dedup_bytes.inc(dedup)
        if client_id is not None:
            self._client_log(client_id)["bytes_dedup"] += dedup
        return TransferPlan(needed, moved, dedup)

    # -- Wire: data movement -----------------------------------------------
    def send(self, refs: Iterable[str]) -> Dict[str, bytes]:
        """Wire image of objects: ref -> packed bytes (raw chunk bytes, or
        the packed delta record).  The receiving endpoint's ``recv``
        recomputes every hash, so the wire needs no extra framing.  Bytes
        leaving this store count in ``egress_bytes`` — the primary-egress
        figure the edge tier exists to shrink."""
        out: Dict[str, bytes] = {}
        for r in refs:
            if is_delta_ref(r):
                out[r] = self._delta_bytes(r[len(DELTA_PREFIX):])
            else:
                out[r] = self.get(r)
        self.metrics.egress_bytes.inc(sum(len(b) for b in out.values()))
        return out

    def _client_log(self, client_id: str) -> Dict[str, int]:
        return self.uplinks.setdefault(
            client_id, {"bytes_in": 0, "bytes_dedup": 0, "records": 0,
                        "rejected": 0})

    def recv(self, records: Dict[str, bytes], *,
             client_id: Optional[str] = None) -> int:
        """Validate and store peer-built objects (the Wire write path:
        uplink push, replica delivery, edge demand-fill).

        Every ref is recomputed from the record bytes (content addressing
        doubles as integrity — a tampered upload cannot land under a valid
        ref), and a delta record's parent must already exist here or
        arrive in the same batch; records are applied parents-first so a
        batch may carry a whole chain.  Returns bytes written (dedup'd
        records cost nothing); raises ``IOError`` on a corrupt or
        dangling record, writing none of the batch."""
        raws: List[tuple[str, bytes]] = []
        deltas: List[tuple[str, bytes, DeltaRecord]] = []
        for r, b in records.items():
            if is_delta_ref(r):
                h = r[len(DELTA_PREFIX):]
                if sha256(b) != h:
                    raise IOError(f"ingest: delta {r[:14]} hash mismatch")
                deltas.append((h, b, DeltaRecord.unpack(b)))
            else:
                if sha256(b) != r:
                    raise IOError(f"ingest: chunk {r[:14]} hash mismatch")
                raws.append((r, b))
        # validate every chain before anything is written.  A delta's
        # depth is hashed into the record, so a lied depth cannot be
        # repaired, only rejected — accepting it would poison the
        # ``max_chain`` accounting (depth-0 lies disable rebasing, huge
        # ones force every later delta into a full copy).  Each parent
        # must resolve to a known depth: already in this store, a raw
        # chunk in this batch, or an earlier delta in this batch; no
        # progress means a dangling or cyclic chain.
        depth_of = {r: 0 for r, _ in raws}
        todo = {DELTA_PREFIX + h: (h, b, rec) for h, b, rec in deltas}
        ordered: List[tuple[str, bytes, int]] = []
        while todo:
            progressed = False
            for ref, (h, b, rec) in list(todo.items()):
                p = rec.parent
                if self.has(p):
                    want = self.ref_depth(p) + 1
                elif p in depth_of:
                    want = depth_of[p] + 1
                else:
                    continue
                if rec.depth != want:
                    raise IOError(f"ingest: delta d:{h[:12]} claims depth "
                                  f"{rec.depth}, its chain says {want}")
                depth_of[ref] = want
                ordered.append((h, b, want))
                del todo[ref]
                progressed = True
            if not progressed:
                h = next(iter(todo.values()))[0]
                raise IOError(f"ingest: delta d:{h[:12]} has a dangling "
                              f"or cyclic parent chain")
        written = 0
        for r, b in raws:
            if not self.has(r):
                written += len(b)
            self.put(b)
        for h, b, depth in ordered:
            if not self.has(DELTA_PREFIX + h):
                written += len(b)
            self._write_delta(h, b, depth)
        self.metrics.ingest_bytes.inc(written)
        self.metrics.ingest_records.inc(len(records))
        if self.tel.tracing:
            self.tel.event("ingest", records=len(records), bytes=written,
                           client=client_id)
        if client_id is not None:
            log = self._client_log(client_id)
            log["records"] += len(records)
            log["bytes_in"] += written    # verified bytes, not the claim
        return written

    # -- deprecated pre-Wire names (thin shims) ----------------------------
    def transfer_plan(self, refs: Iterable[str],
                      client_has: set[str]) -> TransferPlan:
        """Deprecated: use ``plan_send``."""
        _warn_wire("ChunkStore.transfer_plan", "plan_send")
        return self.plan_send(refs, client_has)

    def ingest_plan(self, offered: Dict[str, int], *,
                    client_id: Optional[str] = None) -> TransferPlan:
        """Deprecated: use ``plan_recv``."""
        _warn_wire("ChunkStore.ingest_plan", "plan_recv")
        return self.plan_recv(offered, client_id=client_id)

    def export_records(self, refs: Iterable[str]) -> Dict[str, bytes]:
        """Deprecated: use ``send``."""
        _warn_wire("ChunkStore.export_records", "send")
        return self.send(refs)

    def ingest(self, records: Dict[str, bytes], *,
               client_id: Optional[str] = None) -> int:
        """Deprecated: use ``recv``."""
        _warn_wire("ChunkStore.ingest", "recv")
        return self.recv(records, client_id=client_id)

    def wipe(self) -> None:
        """Simulated disk loss: drop every object (fault injection — the
        churn simulator's "the volunteer's disk died" event)."""
        if self.tel.tracing:
            self.tel.event("wipe")
        with self._lock:
            self._mem.clear()
            self._mem_delta.clear()
            self._depths.clear()
            if self.root is not None:
                for sub in ("objects", "deltas"):
                    shutil.rmtree(self.root / sub, ignore_errors=True)
                    (self.root / sub).mkdir(parents=True, exist_ok=True)

    def sweep_tmp(self, max_age_s: float = 60.0) -> int:
        """Unlink ``*.tmp`` orphans left by crashed writers.  Only files
        older than ``max_age_s`` go — a concurrent writer's in-flight temp
        file (same directory, about to ``os.replace``) is never touched."""
        if self.root is None:
            return 0
        now = time.time()
        removed = 0
        for sub in ("objects", "deltas"):
            for p in (self.root / sub).glob("*/*.tmp"):
                try:
                    if now - p.stat().st_mtime >= max_age_s:
                        p.unlink()
                        removed += 1
                except OSError:
                    continue                 # raced a writer/another sweep
        return removed

    def gc(self, live: set[str]) -> int:
        """Delete all objects not in the closure of ``live``; returns count
        removed.  (The closure keeps delta parents alive.)

        Mark + sweep run under ``gc_lock``: an async snapshot write holds
        the same lock across "put objects + register manifest", so the
        sweep can never observe (and delete) a half-committed snapshot's
        objects.  Callers that assemble ``live`` from several managers must
        collect it under the same lock (it is reentrant)."""
        with self.gc_lock:
            keep = self.live_closure(live)
            dead = [r for r in self.all_refs() if r not in keep]
            for r in dead:
                self.delete(r)
            self.sweep_tmp()
            return len(dead)


@dataclass
class StoreStats:
    put_bytes: int = 0
    dedup_bytes: int = 0
    chunks: int = 0
    extra: dict = field(default_factory=dict)
