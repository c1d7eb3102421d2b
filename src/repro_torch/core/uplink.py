"""Delta-aware volunteer uplink: quantized round updates as store objects.

A volunteer's per-round gradient update is first quantized to int8 with
per-block scales (``optim/grad_compress`` — the dense wire format), then
the quantized byte image is diffed against the volunteer's previous round
with the same fused probe the snapshot path uses
(``kernels/delta_encode.changed_blocks(emit="records")``), and only the
changed chunks become chunk-store objects.  The XOR payload is computed
over the *quantized* representation, so a sparse update — most gradient
blocks unchanged — uploads a handful of RLE'd delta records instead of
the full int8 payload.

The image stays where the gradients are.  ``leaf_image`` builds it on
their device, and the encoder keeps each leaf's previous image there in
a ``DeviceMirror`` slot, so on the card the diff is one
``fused_delta_tiles`` launch per leaf with nothing copied up: only the
bitmap and the changed tiles come back to the host.  The host keeps the
previous image as numpy too, which the store-chunk records and
``put_delta``'s full bytes are cut from, as in the reference.

Protocol (in-process analogue of the two-round-trip wire exchange):

1. client ``encode()`` writes the round's objects into its *local* store
   and returns an ``UplinkUpdate`` (refs + leaf metadata + a handle to
   that store);
2. server ``plan_recv`` answers which refs it lacks (per-client dedup:
   two volunteers pushing the same zero-chunk move it once);
3. client ``send`` ships exactly those; server ``recv`` re-hashes every
   record and refuses dangling chains.

Both directions speak the unified ``Wire`` protocol
(``plan_send``/``plan_recv``/``send``/``recv`` in ``core/chunkstore``).

``decode_update`` is the server-side fold: resolve each ref chain back to
the quantized image and rebuild the ``Compressed`` leaves — the canonical
round state a re-attaching volunteer (or the validator) reads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.kernels.delta_encode.ops import (DeviceMirror,
                                                  changed_blocks,
                                                  dtype_name, seed_slot)
from repro_torch.optim.grad_compress import BLOCK, Compressed

DEFAULT_UPLINK_CHUNK = 1 << 15           # 32 KiB uplink chunks


@dataclass
class LeafMeta:
    """Shape/dtype sidecar so the server can rebuild ``Compressed`` leaves."""
    shape: tuple
    dtype: str                           # numpy name: "int8"
    blocks: int                          # int8 quantization blocks

    @property
    def q_bytes(self) -> int:
        return self.blocks * BLOCK

    @property
    def image_bytes(self) -> int:        # q int8 payload + f32 scales
        return self.blocks * (BLOCK + 4)


@dataclass
class UplinkUpdate:
    """One volunteer round update: per-leaf refs into the client store."""
    refs: Dict[str, List[str]]
    meta: Dict[str, LeafMeta]
    dense_bytes: int                     # int8+scale wire bytes, no dedup
    store: ChunkStore                    # client-local store holding them

    def all_refs(self) -> List[str]:
        return [r for refs in self.refs.values() for r in refs]


def leaf_image(comp: Compressed) -> torch.Tensor:
    """Flat uint8 image of one quantized leaf, on its device: q int8 bytes
    + f32 scales.  ``blocks * (BLOCK + 4)`` bytes, always a multiple of 4,
    so it can be viewed as int32."""
    q = comp.q.detach().to(torch.int8).contiguous().reshape(-1)
    scale = comp.scale.detach().to(torch.float32).contiguous().reshape(-1)
    return torch.cat([q.view(torch.uint8), scale.view(torch.uint8)])


def flatten_compressed(comp_tree) -> Dict[str, Compressed]:
    """keypath -> Compressed leaf, keyed like snapshot manifests."""
    return dict(tu.flatten_with_keys(
        comp_tree, is_leaf=lambda x: isinstance(x, Compressed)))


class UplinkEncoder:
    """Client-side differencing encoder; one per volunteer.

    Keeps the previous round's quantized byte image (on the host, and in a
    ``DeviceMirror`` slot on the gradients' device) and the refs it
    stored, exactly like ``SnapshotManager`` does for state — the uplink
    is the snapshot pipeline pointed the other way.  ``units`` counts
    ``encode`` calls and ``diffs`` the leaves diffed through
    ``changed_blocks``, one fused launch each: every leaf of every round
    after the one that first sent it."""

    def __init__(self, *, chunk_bytes: int = DEFAULT_UPLINK_CHUNK,
                 max_chain: int = 8, store: ChunkStore | None = None):
        self.store = store or ChunkStore(chunk_bytes=chunk_bytes,
                                         max_chain=max_chain)
        self._mirror: Dict[str, np.ndarray] = {}
        self._slots = DeviceMirror()
        self._prev_refs: Dict[str, List[str]] = {}
        self.units = 0
        self.diffs = 0

    def encode(self, comp_tree) -> UplinkUpdate:
        """Encode one round's quantized update into store objects."""
        cb = self.store.chunk_bytes
        refs: Dict[str, List[str]] = {}
        meta: Dict[str, LeafMeta] = {}
        dense = 0
        self.units += 1
        for key, comp in flatten_compressed(comp_tree).items():
            img = leaf_image(comp)
            dense += img.numel()
            meta[key] = LeafMeta(tuple(comp.q.shape),
                                 dtype_name(comp.q.dtype),
                                 comp.scale.numel())
            prev = self._mirror.get(key)
            if prev is None or prev.size != img.numel() \
                    or key not in self._prev_refs:
                host = img.cpu().numpy()     # img is fresh: no alias
                self._mirror[key] = host
                seed_slot(self._slots, key, img.view(torch.int32))
                refs[key] = self.store.put_buffer(memoryview(host))
                self._prev_refs[key] = refs[key]
                continue
            # int32 views: the image is 4-aligned, and the diff runs where
            # the new image lies, against the slot holding the previous one
            records, new_flat, nbytes = changed_blocks(
                torch.from_numpy(prev).view(torch.int32),
                img.view(torch.int32), emit="records", chunk_bytes=cb,
                mirror=self._slots, mirror_key=key)
            self.diffs += 1
            out: List[str] = []
            for ci, pref in enumerate(self._prev_refs[key]):
                xor = records.get(ci)
                if xor is None:
                    out.append(pref)
                else:
                    s, e = ci * cb, min((ci + 1) * cb, nbytes)
                    out.append(self.store.put_delta(
                        pref, xor, full_bytes=new_flat[s:e].tobytes()))
            self._mirror[key] = new_flat
            refs[key] = out
            self._prev_refs[key] = out
        return UplinkUpdate(refs, meta, dense, self.store)

    def gc(self) -> int:
        """Drop everything but the latest round's closure from the local
        store (a volunteer only ever diffs against its last round)."""
        live = {r for refs in self._prev_refs.values() for r in refs}
        return self.store.gc(live)


def push_update(update: UplinkUpdate, server_store: ChunkStore, *,
                client_id: str) -> tuple[int, int]:
    """Move one update into ``server_store``; only missing objects travel.

    -> (bytes moved up, bytes saved by dedup).  Raises ``IOError`` when a
    record fails validation (nothing is written).  Moved bytes come from
    ``recv``'s server-verified count, never the client's offered sizes,
    so the accounting the scheduler credits cannot be inflated."""
    closure = update.store.live_closure(update.all_refs())
    offered = {r: update.store.object_size(r) for r in closure}
    needed, _, dedup = server_store.plan_recv(offered,
                                              client_id=client_id)
    try:
        moved = server_store.recv(update.store.send(needed),
                                  client_id=client_id)
    except Exception:
        # nothing landed: claw the planned dedup back out of the client's
        # credit accounting and mark the rejection
        log = server_store.uplinks[client_id]
        log["bytes_dedup"] -= dedup
        log["rejected"] += 1
        server_store.metrics.ingest_dedup_bytes.inc(-dedup)
        raise
    return moved, dedup


def decode_update(store: ChunkStore, update: UplinkUpdate, *,
                  device="cpu") -> Dict[str, Compressed]:
    """Resolve an update's ref chains back into ``Compressed`` leaves, as
    tensors on ``device`` (the host by default: this is the server's
    fold).

    Raises ``IOError``/``KeyError`` when a chain is broken or the resolved
    image does not match the leaf metadata — the server's chain
    validation."""
    out: Dict[str, Compressed] = {}
    for key, refs in update.refs.items():
        m = update.meta[key]
        img = store.resolve_buffer(refs)
        if len(img) != m.image_bytes:
            raise IOError(f"uplink leaf {key}: resolved {len(img)} bytes, "
                          f"expected {m.image_bytes}")
        buf = torch.frombuffer(bytearray(img), dtype=torch.uint8) \
            if img else torch.empty(0, dtype=torch.uint8)
        q = buf[:m.q_bytes].view(torch.int8).reshape(m.blocks, BLOCK)
        scale = buf[m.q_bytes:].view(torch.float32)
        out[key] = Compressed(q.to(device), scale.to(device))
    return out
