"""The device trace of a ``--trace 1`` run: ``torch.profiler`` with CUDA
activity only (CUPTI), read off its raw events.

The profiler's timestamps are put on the host's ``perf_counter`` clock by
one marker: right after the trace starts, with the device idle, the
harness notes the host time and launches a short kernel; its start less
that time is the offset.  Idle gaps of the device are then named by the
innermost harness span that holds them.
"""
from __future__ import annotations

import bisect
import time
from typing import Dict, List

import torch

TOP = 10


class DeviceTrace:
    def __init__(self):
        self.prof = None
        self.offset_ns = 0
        self.events: List[tuple] = []     # (name, start s, end s) host clock
        self.t_stop = float("inf")        # host time the trace stopped

    @property
    def active(self) -> bool:
        return self.prof is not None

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        torch.cuda.synchronize()
        self._mark_host = time.perf_counter_ns()
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        return self

    def __exit__(self, *exc):
        if self.active:
            self.stop()
        return False

    def stop(self) -> None:
        """End the trace (a driver may end it before its window does, to
        bound the events it holds) and read its device events."""
        torch.cuda.synchronize()
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)
        raw = [(e.name(), e.start_ns(), e.end_ns())
               for e in self.prof.profiler.kineto_results.events()
               if e.device_type().name == "CUDA"]
        self.prof = None
        raw.sort(key=lambda e: e[1])
        marks = [e for e in raw if "spin_kernel" in e[0] or "sleep" in e[0]]
        mark = marks[0] if marks else raw[0] if raw else None
        self.offset_ns = (mark[1] - self._mark_host) if mark else 0
        self.events = [(n, (s - self.offset_ns) / 1e9,
                        (e - self.offset_ns) / 1e9)
                       for n, s, e in raw if (n, s, e) != mark]

    def in_window(self, t0: float, t1: float) -> List[tuple]:
        return [(n, max(s, t0), min(e, t1)) for n, s, e in self.events
                if e > t0 and s < t1]

    def kernel_seconds(self, t0: float, t1: float, needle: str) -> float:
        """Device seconds of the kernels whose name holds ``needle``."""
        return sum(e - s for n, s, e in self.in_window(t0, t1) if needle in n)

    def busy(self, t0: float, t1: float) -> tuple:
        """(busy seconds, [idle gaps (start, end)]) inside [t0, t1]: the
        union of every device activity's interval, and its complement."""
        busy, gaps, cur_s, cur_e = 0.0, [], None, t0
        for _, s, e in sorted(self.in_window(t0, t1), key=lambda x: x[1]):
            if cur_s is None or s > cur_e:
                if cur_s is not None:
                    busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_s is not None:
            busy += cur_e - cur_s
        gaps.append((cur_e, t1))
        return busy, [(a, b) for a, b in gaps if b > a]

    def summary(self, t0: float, t1: float,
                spans: Dict[str, List[tuple]]) -> dict:
        """``busy_s``, ``window_s`` and the breakdown: the device
        operations that took most time, and the idle time by the harness
        span that held it (``between calls`` where none did)."""
        busy, gaps = self.busy(t0, t1)
        by_op: Dict[str, float] = {}
        for n, s, e in self.in_window(t0, t1):
            by_op[n[:120]] = by_op.get(n[:120], 0.0) + (e - s)
        # each gap goes to the shortest span that holds its midpoint
        mids = [(a + b) / 2 for a, b in gaps]
        holder: List[tuple] = [(float("inf"), "between calls")] * len(gaps)
        for name, ivs in spans.items():
            for s, e in ivs:
                for k in range(bisect.bisect_left(mids, s),
                               bisect.bisect_right(mids, e)):
                    if e - s < holder[k][0]:
                        holder[k] = (e - s, name)
        by_host: Dict[str, float] = {}
        for (a, b), (_, name) in zip(gaps, holder):
            by_host[name] = by_host.get(name, 0.0) + (b - a)
        top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
        idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
        return {"busy_s": busy, "window_s": t1 - t0,
                "breakdown": {"device_ops": [[k, v] for k, v in top],
                              "idle_gaps": [[k, v] for k, v in idle]}}

