"""Background snapshot store writer — the zero-stall half of a snapshot.

The snapshot hot path used to pay for chunk hashing, zero-run RLE, store
writes and ``max_chain`` rebase compaction inline; the trainer stalled for
all of it.  ``SnapshotWriter`` moves that work to one background thread
behind a bounded queue:

* **Double buffering** — the trainer plans snapshot N+1 (device probe +
  changed-tile transfer) while the writer persists snapshot N.  Plans are
  self-contained (they carry the changed chunks' XOR *and* full bytes), so
  the writer never reads the planner's mirror — no shared mutable state
  between the two threads beyond the queue.
* **Backpressure** — the queue is bounded (``depth``); when the writer
  falls behind, ``submit`` blocks and the blocked time is accounted as
  ``backpressure_ms`` (it is trainer-visible stall, not hidden).
* **Fail-stop** — a failed write poisons the writer: every queued and
  later submission fails fast with the original error chained, because a
  write after a failed write would record delta refs against parents that
  were never persisted.  The owner observes the failure (via the returned
  future), re-bases its mirror, and calls ``reset``.

Crash consistency is the manager's invariant, unchanged: a manifest is
registered only after every object write lands, so a half-written snapshot
is invisible and the store never serves a torn committed snapshot.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional

from repro_torch.core import telemetry as tlm

_STOP = object()


class WriterPoisonedError(RuntimeError):
    """A snapshot write was refused because an earlier write failed."""


class SnapshotWriter:
    def __init__(self, write_fn: Callable, depth: int = 2, *,
                 telemetry: Optional[tlm.Telemetry] = None):
        if depth < 1:
            raise ValueError("writer depth must be >= 1")
        self.write_fn = write_fn
        self.depth = depth
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self.error: Optional[BaseException] = None
        self.tel = tlm.resolve(telemetry)
        scope = self.tel.scope("writer")
        self.metrics = scope.counters("submitted", "written", "failed")
        # ms accumulators are float-valued counters; same dict keys as ever
        self.metrics.backpressure_ms = scope.counter("backpressure_ms", 0.0)
        self.metrics.write_ms = scope.counter("write_ms", 0.0)
        self.stats = scope.view()
        self._thread = threading.Thread(
            target=self._loop, name="snapshot-writer", daemon=True)
        self._thread.start()

    # ------------------------------------------------------------------
    def submit(self, *args) -> Future:
        """Enqueue one write; blocks only when the bounded queue is full
        (counted as ``backpressure_ms`` — real trainer-visible stall)."""
        if self.error is not None:
            raise WriterPoisonedError(
                "snapshot writer poisoned by an earlier failure"
            ) from self.error
        fut: Future = Future()
        t0 = time.perf_counter()
        self._q.put((fut, args))
        self.tel.add_span("snapshot.backpressure", t0)
        self.metrics.backpressure_ms.inc((time.perf_counter() - t0) * 1e3)
        self.metrics.submitted.inc()
        return fut

    def _loop(self) -> None:
        while True:
            item = self._q.get()
            if item is _STOP:
                return
            fut, args = item
            if self.error is not None:
                # fail-stop: later writes would chain refs onto parents
                # that never landed
                fut.set_exception(WriterPoisonedError(
                    "snapshot writer poisoned by an earlier failure"))
                continue
            t0 = time.perf_counter()
            try:
                res = self.write_fn(*args)
            except BaseException as exc:  # noqa: BLE001 — forwarded via future
                self.error = exc
                self.metrics.failed.inc()
                fut.set_exception(exc)
            else:
                self.metrics.written.inc()
                fut.set_result(res)
            finally:
                self.metrics.write_ms.inc((time.perf_counter() - t0) * 1e3)

    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Clear the poison flag after the owner has re-based its state
        (next snapshot must be a full base image)."""
        self.error = None

    def close(self) -> None:
        self._q.put(_STOP)
        self._thread.join(timeout=30.0)
