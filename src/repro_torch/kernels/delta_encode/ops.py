"""Bucketed whole-state probe, the one-shot delta API, and host-side
compaction for snapshots.

``probe_leaves`` is the SnapshotManager hot path: it diffs a dict of leaves
against a ``DeviceMirror`` of the previous snapshot's tiles, one fused
launch per power-of-two size bucket plus one per leaf larger than
``MAX_BUCKET_TILES``, and brings back only the bitmaps and the changed
tiles.  A missing or layout-mismatched slot seeds itself from the new
tiles and reports its leaves as un-probed (``None``) so the caller stores
a base image.  ``chunk_records``/``apply_tiles`` fold the tiles into
store-chunk XOR records on the host.

The one-shot API diffs a single tensor: ``diff_blocks`` (every XOR tile,
``kernel.delta_encode``, compacted) and ``patch_blocks``
(``kernel.delta_apply``) round-trip it exactly; ``changed_blocks``
returns the changed tiles (or store-chunk records) through the fused
probe or, with ``fused=False``, through ``kernel.changed_bitmap`` and the
plain ``gather_delta``.  Dtypes outside ``KERNEL_DTYPES`` go through the
same kernels on a byte view (``_byte_tiles``, the same bits the
reference's numpy oracle diffs).

The tensors' device picks the route (``kernel.fused_delta_tiles``): the
CUDA kernel on the card, its plain version on the CPU.  Both give the same
bits and take the same slot lifecycle.

Mutable tensors.  The reference skips a leaf when the mirror was built
from the very same immutable array.  Torch tensors change in place, so
the skip here also requires the tensor's in-place version counter to be
the one recorded, and a slot owns its bytes: when the tile view of a leaf
is the leaf's own storage (whole-tile float32/int32 leaves), the slot
keeps a clone.  The trainer's AdamW is functional (new tensors each step,
as in JAX), so the clone costs one state image of device memory, the same
double buffer the reference keeps by reference; it is what makes an
in-place ``add_`` between two probes show up in the diff.

``KERNEL_STATS`` counts probe passes (a CPU pass counts as one launch, as
the reference counts its ref passes), streamed and transferred bytes, and
on the card the kernels' event time and the device-to-host copy time.
"""
from __future__ import annotations

import time
import weakref
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.kernels.delta_encode.kernel import (LANE, SUB, TILE,
                                                     _bitcast_back,
                                                     as_i32_tiles,
                                                     changed_bitmap,
                                                     delta_apply,
                                                     delta_encode,
                                                     fused_delta_tiles,
                                                     gather_delta)

TILE_BYTES = TILE * 4          # one (8, 1024) i32 tile = 32 KiB of state
_EMPTY_TILES = np.zeros((0, SUB, LANE), np.int32)

# dtypes the kernel bitcasts; other leaves are probed leaf-wise through a
# byte view of their storage
KERNEL_DTYPES = ("int32", "float32", "bfloat16", "float16", "int16")

# leaves larger than this many tiles get their own launch; smaller ones are
# concatenated per power-of-two size bucket (256 tiles = 8 MiB of state)
MAX_BUCKET_TILES = 256

KERNEL_STATS = {"launches": 0, "probe_bytes": 0, "d2h_bytes": 0,
                "kernel_ms": 0.0, "d2h_ms": 0.0}

_NP_NAMES = {torch.float32: "float32", torch.float64: "float64",
             torch.float16: "float16", torch.bfloat16: "bfloat16",
             torch.int8: "int8", torch.int16: "int16", torch.int32: "int32",
             torch.int64: "int64", torch.uint8: "uint8", torch.bool: "bool"}
_TORCH_DTYPES = {v: k for k, v in _NP_NAMES.items()}


def dtype_name(dtype: torch.dtype) -> str:
    """The numpy name manifests record (``float32``, not ``torch.float32``)."""
    try:
        return _NP_NAMES[dtype]
    except KeyError:
        raise TypeError(f"no manifest name for {dtype}") from None


def dtype_from_name(name: str) -> torch.dtype:
    try:
        return _TORCH_DTYPES[name]
    except KeyError:
        raise TypeError(f"unknown manifest dtype {name!r}") from None


def reset_kernel_stats() -> dict:
    prev = dict(KERNEL_STATS)
    for k, v in KERNEL_STATS.items():
        KERNEL_STATS[k] = type(v)(0)
    return prev


def _count_launch(tile_bytes: int, d2h: int) -> None:
    KERNEL_STATS["launches"] += 1
    KERNEL_STATS["probe_bytes"] += 2 * tile_bytes   # streams old + new
    KERNEL_STATS["d2h_bytes"] += d2h


class DeviceMirror:
    """Previous-state tiles per leaf (or per size bucket), on the leaves'
    device.  A slot holds (layout, tiles, stamps): ``stamps`` are weak
    references plus in-place version counters of the leaves the slot was
    built from, so the next probe can skip leaves provably untouched
    without pinning old tensors in memory."""

    def __init__(self):
        self._slots: Dict[Any, tuple] = {}  # key -> (layout, tiles, stamps)

    def get(self, key, layout):
        ent = self._slots.get(key)
        if ent is None or ent[0] != layout:
            return None
        return ent[1]

    def refs(self, key, layout):
        ent = self._slots.get(key)
        if ent is None or ent[0] != layout:
            return None
        return ent[2]

    def swap(self, key, layout, tiles, refs=None) -> None:
        self._slots[key] = (layout, tiles, refs)

    def drop(self, key=None) -> None:
        if key is None:
            self._slots.clear()
        else:
            self._slots.pop(key, None)

    clear = drop

    def __len__(self) -> int:
        return len(self._slots)

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size()
                   for _, t, _ in self._slots.values())


def _stamp(leaf: torch.Tensor) -> tuple:
    return weakref.ref(leaf), leaf._version


def _untouched(leaf: torch.Tensor, stamp: tuple) -> bool:
    """Same tensor object as the slot's and no in-place write since."""
    ref, version = stamp
    return ref() is leaf and leaf._version == version


def _owned(tiles: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A slot must not alias the leaf: an in-place update would rewrite the
    'previous' image along with the leaf and every diff would read zero."""
    if tiles.untyped_storage().data_ptr() == \
            leaf.untyped_storage().data_ptr():
        return tiles.clone()
    return tiles


def _byte_tiles(x: torch.Tensor) -> torch.Tensor:
    """(nblk, SUB, LANE) int32 tiles over the raw bytes of any dtype."""
    b = x.reshape(-1).view(torch.uint8)
    pad = (-b.numel()) % TILE_BYTES
    if pad:
        b = torch.cat([b, b.new_zeros(pad)])
    return b.view(torch.int32).view(-1, SUB, LANE)


def _leaf_tiles(x: torch.Tensor, dt: str) -> torch.Tensor:
    return as_i32_tiles(x)[0] if dt in KERNEL_DTYPES else _byte_tiles(x)


def leaf_meta(leaf: torch.Tensor) -> tuple:
    """(nbytes, exact tile count, dtype name) of one leaf."""
    nbytes = leaf.numel() * leaf.element_size()
    n_i32 = -(-nbytes // 4)
    return nbytes, -(-n_i32 // TILE), dtype_name(leaf.dtype)


def plan_buckets(metas: Dict[str, tuple], *, bucketed: bool = True,
                 max_bucket_tiles: int = MAX_BUCKET_TILES) -> list:
    """Group leaves by launch: -> sorted [(bucket id, [(key, nbytes,
    ntiles, dtype)])].  -2: leaf-wise byte-view probes (dtypes the kernel
    does not bitcast); -3: standalone leaves; k >= 0: one concatenated
    launch for the leaves of 2**(k-1) < ntiles <= 2**k tiles."""
    buckets: Dict[int, list] = {}
    for key, (nbytes, ntiles, dt) in metas.items():
        if dt not in KERNEL_DTYPES:
            bid = -2
        elif not bucketed or ntiles > max_bucket_tiles:
            bid = -3
        else:
            bid = (ntiles - 1).bit_length()      # pow2 size class
        buckets.setdefault(bid, []).append((key, nbytes, ntiles, dt))
    return sorted(buckets.items())


def _launch(o32: torch.Tensor, n32: torch.Tensor):
    """One fused probe; on the card bracketed by timing events."""
    if not o32.is_cuda:
        return (*fused_delta_tiles(o32, n32), None)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    bitmap, tiles = fused_delta_tiles(o32, n32)
    end.record()
    return bitmap, tiles, (start, end)


def _fetch_compacted(bitmap_dev: torch.Tensor, tiles_dev: torch.Tensor,
                     tile_bytes: int, events=None):
    """Host side of a fused launch: read the (tiny) bitmap, then transfer
    exactly the k compacted tiles.  -> (bitmap, tiles) as numpy."""
    bitmap = bitmap_dev.cpu().numpy()       # waits for the launch
    if events is not None:
        events[1].synchronize()
        KERNEL_STATS["kernel_ms"] += events[0].elapsed_time(events[1])
    k = int(bitmap.sum())
    t0 = time.perf_counter()
    tiles = tiles_dev[:k].cpu().numpy() if k else _EMPTY_TILES
    KERNEL_STATS["d2h_ms"] += (time.perf_counter() - t0) * 1e3
    _count_launch(tile_bytes, bitmap.nbytes + k * TILE_BYTES)
    return bitmap, tiles


def probe_leaves(news: Dict[str, torch.Tensor], *, mirror: DeviceMirror,
                 bucketed: bool = True,
                 max_bucket_tiles: int = MAX_BUCKET_TILES):
    """Diff a dict of leaves against the mirror slots.

    -> {key: (changed_tiles, bitmap, nbytes) | None}, numpy on the host.
    ``None`` means the mirror had no matching slot (first snapshot, a
    shape/dtype change, or a size bucket whose membership changed): the
    caller stores those leaves as base images; their tiles are installed
    as the slot in the same pass, so the next round probes them."""
    metas = {key: leaf_meta(leaf) for key, leaf in news.items()}
    out: Dict[str, Any] = {}
    for bid, leaves in plan_buckets(metas, bucketed=bucketed,
                                    max_bucket_tiles=max_bucket_tiles):
        if bid < 0:
            for key, nbytes, ntiles, dt in leaves:
                out[key] = _probe_slot(key, news[key], (nbytes, ntiles, dt),
                                       mirror)
        else:
            out.update(_probe_bucket(bid, leaves, news, mirror))
    return out


def _probe_slot(key, leaf: torch.Tensor, meta: tuple, mirror: DeviceMirror):
    """Probe one standalone leaf against its own mirror slot (or seed it)."""
    nbytes, ntiles, dt = meta
    layout = ("leaf", nbytes, ntiles, dt)
    prev = mirror.refs(key, layout)
    if prev is not None and _untouched(leaf, prev[0]):
        return _EMPTY_TILES, np.zeros(ntiles, np.int32), nbytes
    n32 = _leaf_tiles(leaf, dt)
    o32 = mirror.get(key, layout)
    mirror.swap(key, layout, _owned(n32, leaf), (_stamp(leaf),))
    if o32 is None:
        return None
    if ntiles == 0:
        return _EMPTY_TILES, np.zeros(0, np.int32), nbytes
    bm, tiles_dev, events = _launch(o32, n32)
    bitmap, tiles = _fetch_compacted(bm, tiles_dev,
                                     n32.numel() * 4, events)
    return tiles, bitmap, nbytes


def _probe_bucket(bid: int, leaves: list, news: dict, mirror: DeviceMirror):
    """One fused launch over a size bucket's concatenated leaves, against
    the bucket's mirror slot.  A layout mismatch (bucket membership or any
    leaf's shape/dtype changed) re-seeds the slot and reports every leaf
    as un-probed (None)."""
    layout = tuple((key, nb, nt, dt) for key, nb, nt, dt in leaves)
    skey = ("bucket", bid)
    if all(nt == 0 for _, _, nt, _ in leaves):   # all-empty bucket
        seeded = mirror.get(skey, layout) is not None
        mirror.swap(skey, layout, _EMPTY_TILES)
        return {key: ((_EMPTY_TILES, np.zeros(0, np.int32), nb)
                      if seeded else None)
                for key, nb, _, _ in leaves}
    leaf_objs = [news[key] for key, _, _, _ in leaves]
    prev = mirror.refs(skey, layout)
    if prev is not None and len(prev) == len(leaf_objs) and all(
            _untouched(n, p) for n, p in zip(leaf_objs, prev)):
        return {key: (_EMPTY_TILES, np.zeros(nt, np.int32), nb)
                for key, nb, nt, _ in leaves}
    parts = [_leaf_tiles(x, dt) for x, (_, _, _, dt) in zip(leaf_objs, leaves)]
    if len(parts) == 1:
        n32 = parts[0]
        slot = _owned(n32, leaf_objs[0])
    else:
        n32 = slot = torch.cat(parts)
    o32 = mirror.get(skey, layout)
    mirror.swap(skey, layout, slot, tuple(_stamp(x) for x in leaf_objs))
    if o32 is None:
        return {key: None for key, _, _, _ in leaves}
    bm, tiles_dev, events = _launch(o32, n32)
    bitmap, tiles = _fetch_compacted(bm, tiles_dev, n32.numel() * 4, events)
    # split the concatenated bitmap + ascending-order compacted tiles back
    # into per-leaf results
    out = {}
    off = pos = 0
    for key, nbytes, ntiles, _dt in leaves:
        bm_leaf = bitmap[off:off + ntiles]
        k = int(bm_leaf.sum())
        out[key] = (tiles[pos:pos + k], bm_leaf, nbytes)
        off += ntiles
        pos += k
    return out


def _tensor_pair(old: torch.Tensor, new: torch.Tensor) -> str:
    """Validate a diff pair; -> the dtype's manifest name.  A dtype
    mismatch is an error: bitcasting two layouts would diff garbage."""
    if old.dtype != new.dtype:
        raise TypeError(f"old dtype {old.dtype} != new dtype {new.dtype}; "
                        "diff pairs must share a bit layout")
    if old.numel() != new.numel():
        raise ValueError(f"old has {old.numel()} elements, new "
                         f"{new.numel()}")
    return dtype_name(old.dtype)


def diff_blocks(old: torch.Tensor, new: torch.Tensor):
    """-> (changed_tiles (k, 8, 1024) int32, bitmap (nblk,) int32, n), numpy
    on the host; n is the int32 word count before tile padding, as the
    reference's kernel route returns it (its numpy route returns the
    element count, which differs for 16-bit dtypes).  It runs where
    ``new`` lies, as ``changed_blocks`` does: a host image diffed against
    a live leaf on the card goes through the kernel."""
    dt = _tensor_pair(old, new)
    delta, bitmap = delta_encode(_leaf_tiles(old.to(new.device), dt),
                                 _leaf_tiles(new, dt))
    words = -(-old.numel() * old.element_size() // 4)
    return (delta[bitmap.bool()].cpu().numpy(), bitmap.cpu().numpy(),
            words)


def patch_blocks(old: torch.Tensor, changed_tiles, bitmap) -> torch.Tensor:
    """Rebuild ``new`` (old's shape, dtype and device) from ``old`` and the
    compacted changed tiles of ``diff_blocks``."""
    o32 = _leaf_tiles(old, dtype_name(old.dtype))
    mask = torch.as_tensor(bitmap, device=old.device).bool()
    full = torch.zeros_like(o32)
    full[mask] = torch.as_tensor(changed_tiles, device=old.device)
    return _bitcast_back(delta_apply(o32, full), old.shape, old.dtype)


def changed_blocks(old: torch.Tensor, new: torch.Tensor, *,
                   emit: str = "tiles", chunk_bytes: int = 0,
                   fused: bool = True, mirror: Optional[DeviceMirror] = None,
                   mirror_key=None):
    """Diff of one tensor: -> (changed_tiles (k, 8, 1024) int32, bitmap
    (nblk,) int32, nbytes), numpy on the host; only the bitmap and the k
    changed tiles leave the device.  ``fused=False`` runs the two-pass
    route (``changed_bitmap``, then ``gather_delta`` of the changed tiles
    when there are any), counted as 1 + 1 launches in ``KERNEL_STATS``.

    ``mirror``/``mirror_key`` (fused route only, as in the reference): a
    ``DeviceMirror`` slot holding the previous tiles on the device.  When
    it matches, it is diffed instead of ``old``; either way the slot then
    holds the new tiles.  The slot owns its bytes (``_owned``), so an
    in-place update of ``new`` before the next call still shows there.
    ``old`` must still be the previous image: it feeds the records.

    ``emit="records"`` -> (records {chunk index: XOR bytes} for exactly
    the store chunks whose bytes changed, the new uint8 host image,
    nbytes); it needs ``chunk_bytes``.  The reference's ``mode`` is gone:
    the tensors' device picks the kernels or their plain versions."""
    dt = _tensor_pair(old, new)
    if emit not in ("tiles", "records"):
        raise ValueError(f"unknown emit mode {emit!r}")
    if emit == "records" and chunk_bytes <= 0:
        raise ValueError("emit='records' requires chunk_bytes")
    nbytes = old.numel() * old.element_size()
    n32 = _leaf_tiles(new, dt)
    tile_bytes = n32.numel() * 4
    if fused:
        layout = (n32.shape[0], nbytes)
        o32 = mirror.get(mirror_key, layout) if mirror is not None else None
        if o32 is None:
            o32 = _leaf_tiles(old.to(new.device), dt)
        bm, tiles_dev, events = _launch(o32, n32)
        bitmap, tiles = _fetch_compacted(bm, tiles_dev, tile_bytes, events)
        if mirror is not None:
            mirror.swap(mirror_key, layout, _owned(n32, new))
    else:
        o32 = _leaf_tiles(old.to(new.device), dt)
        bitmap = changed_bitmap(o32, n32).cpu().numpy()
        _count_launch(tile_bytes, bitmap.nbytes)
        idx = np.flatnonzero(bitmap)
        tiles = _EMPTY_TILES
        if idx.size:
            tiles = gather_delta(o32, n32, torch.as_tensor(
                idx, device=n32.device)).cpu().numpy()
            _count_launch(tile_bytes, idx.size * TILE_BYTES)
    if emit == "tiles":
        return tiles, bitmap, nbytes
    host_old = old.detach().reshape(-1).view(torch.uint8).cpu().numpy()
    records, new_flat = chunk_records(host_old, tiles, bitmap, nbytes,
                                      chunk_bytes)
    return records, new_flat, nbytes


def chunk_records(prev: np.ndarray, tiles: np.ndarray, bitmap: np.ndarray,
                  nbytes: int, chunk_bytes: int):
    """Compact changed tiles into store-ready per-chunk XOR records.

    -> (records: {chunk index -> XOR bytes}, new_flat uint8 image).
    Tiles (32 KiB probe granules) rarely align with store chunks; a chunk
    is recorded only when its bytes actually differ, so a tile flip that
    straddles two chunks but only dirties one emits one record.
    """
    old_flat = np.ascontiguousarray(prev).reshape(-1).view(np.uint8)
    if not bitmap.any():
        return {}, old_flat    # unchanged leaf: no records, no host copy
    new_flat = apply_tiles(old_flat.copy(), tiles, bitmap)
    # touched chunk set, vectorized: each changed tile covers byte range
    # [s, e) which spans chunks [s // cb, (e-1) // cb]
    ti = np.flatnonzero(bitmap)
    s = ti * TILE_BYTES
    e = np.minimum(s + TILE_BYTES, nbytes)
    valid = e > s
    s, e = s[valid], e[valid]
    records: dict[int, bytes] = {}
    if s.size == 0:
        return records, new_flat
    c0, c1 = s // chunk_bytes, (e - 1) // chunk_bytes
    width = int((c1 - c0).max()) + 1         # chunks per tile, usually <= 2
    cand = c0[:, None] + np.arange(width)[None, :]
    chunks = np.unique(cand[cand <= c1[:, None]])
    for ci in chunks:
        cs, ce = int(ci) * chunk_bytes, min((int(ci) + 1) * chunk_bytes,
                                            nbytes)
        xor = old_flat[cs:ce] ^ new_flat[cs:ce]
        if xor.any():
            records[int(ci)] = xor.tobytes()
    return records, new_flat


def apply_tiles(flat_u8: np.ndarray, tiles: np.ndarray,
                bitmap: np.ndarray) -> np.ndarray:
    """XOR compacted changed tiles into a flat uint8 buffer, in place.

    ``flat_u8`` is the previous state's byte image; tile ``i`` covers bytes
    ``[i*TILE_BYTES, (i+1)*TILE_BYTES)`` of the (padded) stream — the tail
    tile is clipped to the buffer length.  Returns ``flat_u8``.
    """
    nbytes = flat_u8.size
    idx = np.flatnonzero(bitmap)
    if idx.size == 0:
        return flat_u8
    tb = np.ascontiguousarray(tiles[:idx.size]).reshape(idx.size, -1) \
        .view(np.uint8)                       # (k, TILE_BYTES)
    nfull = nbytes // TILE_BYTES
    body = idx < nfull
    if body.any():
        # one reshaped scatter-XOR for every whole tile
        view = flat_u8[:nfull * TILE_BYTES].reshape(nfull, TILE_BYTES)
        view[idx[body]] ^= tb[body]
    for j in np.flatnonzero(~body):           # at most the one tail tile
        s = int(idx[j]) * TILE_BYTES
        e = min(s + TILE_BYTES, nbytes)
        if e > s:
            flat_u8[s:e] ^= tb[j, :e - s]
    return flat_u8
