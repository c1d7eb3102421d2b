"""Continuous-batching serving engine (``repro.serving.engine``).

Decode runs over a fixed pool of batch *slots*; requests are admitted into
free slots as others finish, each slot tracking its own sequence position
(the vectorized ``index`` path through ``attn_decode``).  Prefill runs per
request at batch 1, its attention in the flash-attention kernel and its
selective scan in the ``ssm_scan`` kernel, and the request's cache strip
(KV rows, SSM conv tail and state) is copied into the pool cache at the
slot's batch row.  PyTorch runs eagerly, so the reference's per-length
compile cache has no counterpart; the ``prefills`` counter stays.

The engine holds one copy of the params in the compute dtype, made once
(see ``lm.cast_tree``).

On the card the decode step is one CUDA graph (``DecodeGraph``), captured
at the engine's first decode step over its own params and pool caches
and replayed at every later step; anywhere else (the CPU, a mesh's
DTensor leaves) it runs eagerly.  The serving scope's
``decode_graph_replays`` counts the steps that replayed it.

Requests are timed from ``Request.submitted``: the caller's stamp of its
hand-off, or, where the caller set none, the moment ``run_queue`` is
handed the request.  The default telemetry hub records the spans
``engine.queue`` (submitted to admission), ``engine.admit``,
``engine.step`` (a decode step with its token readback) and, inside the
callable stored as ``_decode``, ``engine.step.dispatch``, and within it
``engine.step.replay`` around a graph's replay.
"""
from __future__ import annotations

import time
import warnings
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch
from torch.distributed.tensor import DTensor
from torch.overrides import TorchFunctionMode

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.core import telemetry as tlm
from repro_torch.models import api
from repro_torch.models.lm import RunConfig, cast_tree


@dataclass
class Request:
    request_id: int
    prompt: np.ndarray            # (prompt_len,) int32
    max_new_tokens: int
    submitted: Optional[float] = None    # perf_counter of the hand-off
    # filled by the engine
    output: List[int] = field(default_factory=list)
    first_token_s: Optional[float] = None
    done_s: Optional[float] = None


def graphable(params, caches) -> bool:
    """Whether a decode step over ``params`` and ``caches`` may be captured
    as a CUDA graph: every leaf a plain tensor on a CUDA device (a mesh's
    DTensor leaves, and the CPU, run eagerly)."""
    return all(x.is_cuda and not isinstance(x, DTensor)
               for x in tu.leaves(params) + tu.leaves(caches))


class _NumbersAsFills(TorchFunctionMode):
    """``torch.tensor(<number>, device=<card>)`` as ``torch.full``: the
    same value, held by a fill kernel's argument.  ``torch.tensor`` copies
    the number from pageable host memory and waits for the copy, which a
    CUDA graph's capture refuses (``layers.rotary`` makes its ``theta`` so
    inside the decode step)."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.tensor and len(args) == 1
                and isinstance(args[0], (int, float))
                and set(kwargs) <= {"dtype", "device"}
                and torch.device(kwargs.get("device", "cpu")).type == "cuda"):
            return torch.full((), args[0], **kwargs)
        return func(*args, **kwargs)


class DecodeGraph:
    """A decode step ``decode(params, caches, batch) -> (logits, caches)``
    replayed as one CUDA graph, bound to the params and caches of its
    first call.

    The first call, where ``graphable`` holds, runs the step eagerly on
    static int32 device buffers for ``tokens`` and ``index`` (the real
    step, which also warms cuBLAS and the allocator), then captures the
    same call with ``torch.cuda.graph`` (numbers put on the card as fills,
    ``_NumbersAsFills``).  Capture records and executes nothing, so the
    step's in-place cache writes are not applied twice.  A later call
    whose params and cache leaves are the very tensors captured, with
    inputs of the captured shapes, copies its inputs through a pinned host
    buffer into the static buffers and replays the graph; its logits are
    the graph's static output, which the next replay overwrites, so a
    caller reads them before its next call.  The caches are updated in
    place and returned, as the eager step does.  Every other call, and
    every call after a capture that failed, runs the step eagerly.

    ``replays`` (a counter) counts the replays, each inside a span
    ``engine.step.replay`` on ``tel``.  The graph's private memory pool
    holds one step's intermediates; the captured params and caches are held
    while the graph lives, since it reads and writes their memory."""

    def __init__(self, decode, replays, tel):
        self.decode, self.replays, self.tel = decode, replays, tel
        self.tried = False
        self.graph = None

    def __call__(self, params, caches, batch: dict):
        inputs = [torch.as_tensor(batch[k]) for k in ("tokens", "index")]
        if self.graph is not None and self._bound(params, caches, inputs):
            self._stage(inputs)
            with self.tel.span("engine.step.replay"):
                self.graph.replay()
            self.replays.inc()
            return self.logits, caches
        if not self.tried:
            self.tried = True
            if graphable(params, caches):
                return self._capture(params, caches, inputs)
        return self.decode(params, caches, batch)

    def _bound(self, params, caches, inputs) -> bool:
        leaves = tu.leaves(params) + tu.leaves(caches)
        return (len(leaves) == len(self.leaves)
                and all(a is b for a, b in zip(leaves, self.leaves))
                and [x.shape for x in inputs] == [x.shape for x in
                                                  self.static])

    def _stage(self, inputs) -> None:
        """``inputs`` into the static buffers: host values into the pinned
        buffer (once its last copy to the card is done), then one
        asynchronous copy on the current stream, ahead of the replay."""
        self.copied.synchronize()
        at = 0
        for x in inputs:
            self.host[at:at + x.numel()].copy_(x.reshape(-1))
            at += x.numel()
        self.flat.copy_(self.host, non_blocking=True)
        self.copied.record()

    def _capture(self, params, caches, inputs):
        device = params["embed"].device
        sizes = [x.numel() for x in inputs]
        self.host = torch.empty(sum(sizes), dtype=torch.int32,
                                pin_memory=True)
        self.flat = torch.empty(sum(sizes), dtype=torch.int32, device=device)
        self.static = [v.view(x.shape) for v, x in
                       zip(self.flat.split(sizes), inputs)]
        self.copied = torch.cuda.Event()
        self.copied.record()
        self._stage(inputs)
        batch = dict(zip(("tokens", "index"), self.static))
        out = self.decode(params, caches, batch)
        stream, graph = torch.cuda.current_stream(), torch.cuda.CUDAGraph()
        try:
            with torch.cuda.graph(graph), _NumbersAsFills():
                self.logits, _ = self.decode(params, caches, batch)
        except RuntimeError as err:
            # a failed capture can leave its side stream current
            torch.cuda.set_stream(stream)
            warnings.warn(f"the decode step runs eagerly: its capture as "
                          f"a CUDA graph failed ({err})")
            return out
        self.graph = graph
        self.leaves = tu.leaves(params) + tu.leaves(caches)
        return out


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params, *, slots: int = 4,
                 max_len: int = 256, run: RunConfig = RunConfig()):
        if cfg.enc_dec:
            raise NotImplementedError("engine serves decoder-only archs")
        self.cfg = cfg
        self.params = cast_tree(params, run.compute_dtype)
        self.slots = slots
        self.max_len = max_len
        self.run = run
        tel = self.tel = tlm.get_default()
        scope = tel.scope("serving")
        self.metrics = scope.counters("served", "decode_steps", "prefills",
                                      "decode_graph_replays")
        self.stats = scope.view()
        decode = DecodeGraph(api.make_decode_step(cfg, run),
                             self.metrics.decode_graph_replays, tel)

        def dispatch(*args):   # holds no reference to the engine
            with tel.span("engine.step.dispatch"):
                return decode(*args)
        self._decode = dispatch
        self._prefill = api.make_prefill_step(cfg, max_len, run)
        device = self.params["embed"].device
        # pool caches: batch dim = slots
        self.caches = tu.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            api.cache_specs(cfg, slots, max_len))
        self.lengths = np.zeros(slots, np.int32)      # per-slot position
        self.active: List[Optional[Request]] = [None] * slots

    # ------------------------------------------------------------------
    def _admit(self, slot: int, req: Request) -> None:
        admitted = self.tel.add_span("engine.queue", req.submitted)
        t = len(req.prompt)
        logits, cache = self._prefill(self.params,
                                      {"tokens": req.prompt[None, :]})
        self.metrics.prefills.inc()

        # copy the request's cache strip into the slot's batch row
        def insert(pool, strip):
            pool[:, slot] = strip[:, 0]
        tu.tree_map(insert, self.caches, cache)
        tok = int(torch.argmax(logits[0, :self.cfg.vocab_size]))
        req.output.append(tok)
        req.first_token_s = time.perf_counter() - req.submitted
        self.lengths[slot] = t
        self.active[slot] = req
        self.tel.add_span("engine.admit", admitted)

    def _retire(self, slot: int) -> Request:
        req = self.active[slot]
        req.done_s = time.perf_counter() - req.submitted
        self.active[slot] = None
        self.lengths[slot] = 0
        self.metrics.served.inc()
        return req

    # ------------------------------------------------------------------
    def run_queue(self, requests: List[Request]) -> List[Request]:
        """Serve a queue to completion; returns finished requests.  A
        request without a ``submitted`` stamp is stamped now."""
        handed = time.perf_counter()
        for req in requests:
            if req.submitted is None:
                req.submitted = handed
        pending = list(requests)
        finished: List[Request] = []
        while pending or any(r is not None for r in self.active):
            # admit into free slots
            for slot in range(self.slots):
                if self.active[slot] is None and pending:
                    self._admit(slot, pending.pop(0))
            # batched decode over every active slot (inactive rows compute
            # too — slot masking, the standard continuous-batching cost)
            tokens = np.zeros((self.slots, 1), np.int32)
            for slot, req in enumerate(self.active):
                if req is not None:
                    tokens[slot, 0] = req.output[-1]
            with self.tel.span("engine.step"):
                logits, self.caches = self._decode(
                    self.params, self.caches,
                    {"tokens": tokens, "index": self.lengths.copy()})
                self.metrics.decode_steps.inc()
                nxt = torch.argmax(logits[:, 0, :self.cfg.vocab_size],
                                   dim=-1).cpu().numpy()
            for slot, req in enumerate(self.active):
                if req is None:
                    continue
                self.lengths[slot] += 1
                req.output.append(int(nxt[slot]))
                if (len(req.output) >= req.max_new_tokens
                        or self.lengths[slot] + 1 >= self.max_len):
                    finished.append(self._retire(slot))
        return finished
