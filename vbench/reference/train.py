"""The reference of a training cell's first steps: the token stream, the
loss and gradient of each unit, their mean, and AdamW, in float32.

The token stream is worked out again from the seed by a frozen copy of
the program's generator (a noisy order-1 Markov stream over the
vocabulary, batch ``i`` a pure function of the seed and ``i``); the
optimizer is AdamW with a linear warm-up and a cosine decay, clipping by
the global norm, and decoupled weight decay on every leaf of two or more
dims, as stored (a stack of per-layer norm scales is such a leaf).
"""
from __future__ import annotations

import math
import re
from typing import Dict, List

import numpy as np
import torch

from vbench.reference import model
from vbench.reference.precision import Precision


def token_batch(vocab: int, seq: int, batch: int, seed: int, index: int,
                order: int = 1, noise: float = 0.05) -> dict:
    """Batch ``index`` of the stream: tokens and labels (B, T) int32."""
    rng0 = np.random.default_rng(seed)
    mix = rng0.integers(1, vocab, size=(order,), dtype=np.int64)
    bias = int(rng0.integers(0, vocab))
    rng = np.random.default_rng((seed, index))
    seqs = np.empty((batch, seq + 1), np.int64)
    seqs[:, :order] = rng.integers(0, vocab, size=(batch, order))
    noisy = rng.random((batch, seq + 1)) < noise
    noise_tok = rng.integers(0, vocab, size=(batch, seq + 1))
    for j in range(order, seq + 1):
        nxt = (seqs[:, j - order:j] @ mix + bias) % vocab
        seqs[:, j] = np.where(noisy[:, j], noise_tok[:, j], nxt)
    return {"tokens": seqs[:, :-1].astype(np.int32),
            "labels": seqs[:, 1:].astype(np.int32)}


def lr_at(o: dict, step: int) -> float:
    warm = min(step / max(o["warmup_steps"], 1), 1.0)
    frac = min(max((step - o["warmup_steps"])
                   / max(o["total_steps"] - o["warmup_steps"], 1), 0.0), 1.0)
    cos = o["min_lr_frac"] + (1 - o["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * frac))
    return o["lr"] * warm * cos


def split_norms(w: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The norm of each leaf, a stacked leaf (``layers.*``) taken layer by
    layer (``layers.attn.wq/3``)."""
    out = {}
    for k, x in w.items():
        x = x.detach().float()
        if k.startswith("layers."):
            for i, n in enumerate(torch.linalg.vector_norm(
                    x.reshape(x.shape[0], -1), dim=1).tolist()):
                out[f"{k}/{i}"] = n
        else:
            out[k] = float(torch.linalg.vector_norm(x))
    return out


def follow(c: dict, w0: Dict[str, torch.Tensor], rounds: List[List[dict]],
           opt: dict, prec: Precision) -> dict:
    """Train from ``w0`` ({dotted name: f32 tensor}) through ``rounds``
    (each a list of unit batches; a round's gradient is the mean of its
    units'), one row at a time so that the activations fit.  -> losses
    per round, the first clipped gradient (``first_grad_t``) with its
    norms, and the parameters' change after the last round, the norms by
    ``split_norms``."""
    dev = next(iter(w0.values())).device
    p = {k: v.detach().clone().requires_grad_(True) for k, v in w0.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    losses, first_grad, first_grad_t = [], None, None
    for step, units in enumerate(rounds, start=1):
        total = 0.0
        for unit in units:
            toks = torch.as_tensor(unit["tokens"], device=dev)
            labs = torch.as_tensor(unit["labels"], device=dev)
            share = 1.0 / (len(units) * toks.shape[0])
            for r in range(toks.shape[0]):
                lo = model.loss(c, p, toks[r:r + 1], labs[r:r + 1], prec)
                (lo * share).backward()
                total += float(lo.detach()) * share
        losses.append(total)
        with torch.no_grad():
            g = {k: x.grad for k, x in p.items()}
            gnorm = math.sqrt(sum(float(x.square().sum()) for x in g.values()))
            scale = min(opt["clip_norm"] / max(gnorm, 1e-9), 1.0)
            lr = lr_at(opt, step)
            b1c, b2c = 1 - opt["beta1"] ** step, 1 - opt["beta2"] ** step
            for k, x in p.items():
                gk = g[k] * scale
                m[k].mul_(opt["beta1"]).add_((1 - opt["beta1"]) * gk)
                v2[k].mul_(opt["beta2"]).add_((1 - opt["beta2"]) * gk.square())
                upd = (m[k] / b1c) / ((v2[k] / b2c).sqrt() + opt["eps"])
                if x.dim() >= 2:
                    upd = upd + opt["weight_decay"] * x
                x.sub_(lr * upd)
                x.grad = None
            if first_grad is None:
                first_grad_t = {k: g[k] * scale for k in p}
                first_grad = split_norms(first_grad_t)
    change = split_norms({k: p[k].detach() - w0[k] for k in p})
    return {"losses": losses, "first_grad": first_grad,
            "first_grad_t": first_grad_t, "change": change}


def dotted(key: str) -> str:
    """A snapshot key's dotted name: ``.params['layers']['attn']['wq']``
    -> ``layers.attn.wq`` (under ``.params``)."""
    return ".".join(re.findall(r"\['([^']+)'\]", key))
