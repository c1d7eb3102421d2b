"""Driver of the serving cells: capsule serving through
``repro_torch.serving.engine.ServingEngine.run_queue``.

``run_queue`` takes a list and serves it to completion, so the traffic is
closed batches handed over back to back; the window counts every batch
that starts in it, and ends with the last of them.  Every seed gets the
same prompt and output lengths in the same order (log-normal quantiles of
the traffic file, in an order fixed by the file), and its own token ids;
the weights are the benchmark's, drawn from the seed in bf16.

``ttft_p90_ms`` is taken from each request's hand-off to ``run_queue``
to its first token (the end of its prefill); ``itl_p95_ms`` over the gaps
between consecutive tokens of one request, each decode step's tokens
stamped when the step's logits are ready on the device.

The check: a sample of the window's requests drawn from the seed, the one
served most tokens among them, run once through the plain reference over
prompt and served tokens; the widest gap by which a served token's logit
lies below the reference's best is compared.
"""
from __future__ import annotations

import gc
import math
import statistics
import time
from typing import List

import numpy as np
import torch

from vbench import costs, stats, weights
from vbench.drivers.train import arch_config, state_keys
from vbench.harness import Run
from vbench.reference import serve as ref_serve
from vbench.reference.precision import Precision, no_tf32
from vbench.reference.train import dotted


def schedule(spec: dict, n: int, order_seed: int) -> List[int]:
    """n lengths at the log-normal's quantiles (i + 1/2) / n, clipped to
    [min, max], in an order drawn from ``order_seed``."""
    nd = statistics.NormalDist()
    vals = [min(max(round(spec["median"] * math.exp(
        spec["sigma"] * nd.inv_cdf((i + 0.5) / n))), spec["min"]),
        spec["max"]) for i in range(n)]
    perm = np.random.default_rng(order_seed).permutation(n)
    return [vals[i] for i in perm]


WARM_UP = 2**40          # the warm-up batch's index: no window batch's


class Session:
    def __init__(self, run: Run, device):
        from repro_torch import tree as tu
        from repro_torch.models import api
        from repro_torch.serving.engine import ServingEngine
        c, tr = run.cell.config, run.cell.traffic
        self.run, self.device, self.c, self.tr = run, device, c, tr
        self.cfg = arch_config(c)
        specs = api.param_specs(self.cfg)
        shapes = {k: tuple(s.shape) for k, s in state_keys(specs)}
        self.w = weights.make(c, shapes, run.seed, device, torch.bfloat16)
        self.params = tu.unflatten_like(specs, self.w)
        self.engine = ServingEngine(self.cfg, self.params, slots=tr["slots"],
                                    max_len=tr["max_len"])
        n = tr["batch_requests"]
        self.prompt_lens = schedule(tr["prompt"], n, tr["order_seed"])
        self.output_lens = schedule(tr["output"], n, tr["order_seed"] + 1)
        self.steps: List[tuple] = []       # (end s, [request ids])
        self.engine._decode = self._stamped(self.engine._decode)

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _stamped(self, decode):
        def step(*args):
            active = [r.request_id for r in self.engine.active
                      if r is not None]
            out = decode(*args)
            self.sync()
            self.steps.append((time.perf_counter(), active))
            return out
        return step

    def batch(self, index: int, n: int = None, new_tokens: int = None):
        from repro_torch.serving.engine import Request
        n = n or len(self.prompt_lens)
        rng = np.random.default_rng((self.run.seed, index))
        reqs = []
        for i in range(n):
            prompt = rng.integers(0, self.c["vocab_size"],
                                  size=self.prompt_lens[i]).astype(np.int32)
            reqs.append(Request(index * n + i, prompt,
                                new_tokens or self.output_lens[i]))
        return reqs

    def warm_up(self) -> None:
        """One batch of as many requests as slots, at the schedule's first
        lengths, a few tokens each: every kernel built and loaded, the
        pool cache and the allocator at their working size."""
        tr = self.tr
        self.engine.run_queue(self.batch(WARM_UP, tr["slots"],
                                         tr["warmup_new_tokens"]))
        self.sync()
        self.steps.clear()


def setup(run: Run, device) -> Session:
    ses = Session(run, device)
    ses.warm_up()
    return ses


def window(ses: Session, run: Run) -> None:
    from repro_torch.kernels.flash_attention import ops as attn_ops
    from repro_torch.kernels.ssm_scan import ops as ssm_ops
    eng, spans = ses.engine, run.spans
    restore = []
    if run.trace:
        def patch(obj, name, new):
            restore.append((obj, name, getattr(obj, name)))
            setattr(obj, name, new)

        def attn_call(args, out):
            q, k = args[0], args[1]
            b, t, h, hd = q.shape
            run.call("flash_attention", **costs.attn_work(
                b, t, k.shape[1], h, k.shape[2], hd, True,
                q.element_size()))

        def scan_call(args, out):
            x, bm = args[0], args[2]
            b, t, di = x.shape
            run.call("ssm_scan", **costs.ssm_work(b, t, di, bm.shape[-1],
                                                  x.element_size()))
        def bound_trace(args, out):
            # the trace holds a decode step's thousands of kernels: it
            # stops after ``trace_seconds``, between two steps
            tracer = run.tracer
            if tracer is not None and tracer.active and \
                    time.perf_counter() > t0 + ses.tr["trace_seconds"]:
                tracer.stop()
        patch(eng, "_prefill", spans.wrap("engine.prefill", eng._prefill,
                                          ses.sync))
        decode = eng._decode
        patch(eng, "_decode", spans.wrap("engine.decode", decode,
                                         after=bound_trace))
        patch(attn_ops, "attend", spans.wrap("kernel.flash_attention",
                                             attn_ops.attend, after=attn_call))
        patch(ssm_ops, "selective_scan",
              spans.wrap("kernel.ssm_scan", ssm_ops.selective_scan,
                         after=scan_call))
    finished, handed, flops = [], 0, 0.0
    t0 = time.perf_counter()   # read by bound_trace
    t_end = t0 + run.seconds
    index = 0
    try:
        while time.perf_counter() < t_end:
            reqs = ses.batch(index)
            hand = time.perf_counter()
            for r in reqs:
                r.submitted = hand
            handed += len(reqs)
            finished += eng.run_queue(reqs)
            index += 1
    finally:
        for obj, name, old in reversed(restore):
            setattr(obj, name, old)
    t_last = time.perf_counter()
    tokens_at = {r.request_id: [r.submitted + r.first_token_s]
                 for r in finished}
    for end, active in ses.steps:
        for rid in active:
            if rid in tokens_at:
                tokens_at[rid].append(end)
    want = {r.request_id: r.max_new_tokens for r in finished}
    served = sum(len(r.output) for r in finished)
    bad = sum(1 for r in finished
              if len(r.output) != want[r.request_id]
              or len(tokens_at[r.request_id]) != len(r.output))
    for r in finished:
        p = len(r.prompt)
        flops += costs.prefill_flops(ses.c, p) + sum(
            costs.decode_flops(ses.c, p + j) for j in range(len(r.output) - 1))
    run.window = (t0, t_last)
    run.attempted = handed
    run.failed = handed - len(finished) + bad
    run.e2e["serve_tokens_per_s"] = stats.batch_rate(t0, t_last, served)
    run.e2e["ttft_p90_ms"] = stats.percentile(
        [r.first_token_s for r in finished], 90) * 1e3
    run.e2e["itl_p95_ms"] = stats.percentile(
        stats.token_gaps(list(tokens_at.values())), 95) * 1e3
    run.facts.update(batches=index, served_tokens=served, model_flops=flops,
                     decode_steps=len(ses.steps))
    ses.finished = finished


def sample(ses: Session) -> list:
    """Requests to check, drawn from the seed: the one served most
    tokens, then others at random until ``check.min_tokens`` served tokens
    or ``check.max_requests`` requests."""
    spec = ses.tr["check"]
    done = sorted(ses.finished, key=lambda r: r.request_id)
    longest = max(done, key=lambda r: (len(r.output), len(r.prompt)))
    rest = [r for r in done if r is not longest]
    order = np.random.default_rng((ses.run.seed, 1)).permutation(len(rest))
    picked, tokens = [longest], len(longest.output)
    for i in order:
        if tokens >= spec["min_tokens"] or len(picked) >= spec["max_requests"]:
            break
        picked.append(rest[i])
        tokens += len(rest[i].output)
    return picked


def check(ses: Session, run: Run, control: Precision = None) -> dict:
    picked = sample(ses)
    ses.engine = None
    gc.collect()
    if ses.device.type == "cuda":
        torch.cuda.empty_cache()
    # the served bf16 weights; the reference upcasts each where it uses it
    w = {dotted(k): x for k, x in ses.w.items()}
    ses.w = ses.params = None
    gaps, ctl = [], []
    with no_tf32():
        for r in picked:
            g = ref_serve.gaps(ses.c, w, r.prompt.tolist(), r.output,
                               control)
            gaps += g["served"]
            ctl += g.get("control", [])
    got = {"served_logit_gap": max(gaps)}
    run.check("served_logit_gap", got["served_logit_gap"],
              run.cell.limits["served_logit_gap"])
    run.check("requests_failed", run.failed, 0)
    run.facts.update(checked_requests=len(picked), checked_tokens=len(gaps))
    if control is None:
        return got
    return {"program": got, "control": {"served_logit_gap": max(ctl)}}
