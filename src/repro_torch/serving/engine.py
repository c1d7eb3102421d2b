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

Requests are timed from ``Request.submitted``: the caller's stamp of its
hand-off, or, where the caller set none, the moment ``run_queue`` is
handed the request.  The default telemetry hub records the spans
``engine.queue`` (submitted to admission), ``engine.admit``,
``engine.step`` (a decode step with its token readback) and, inside the
callable stored as ``_decode``, ``engine.step.dispatch``.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np
import torch

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
        decode = api.make_decode_step(cfg, run)

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
        scope = self.tel.scope("serving")
        self.metrics = scope.counters("served", "decode_steps", "prefills")
        self.stats = scope.view()

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
