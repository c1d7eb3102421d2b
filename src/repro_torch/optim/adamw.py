"""AdamW + cosine schedule + global-norm clipping.

Functional, as in the reference: ``update`` returns new tensors and never
writes into ``params``, ``m`` or ``v``.  That keeps a snapshot's device
mirror valid without a copy per step and lets a caller keep the previous
state; it costs one extra state image of device memory while the update
runs.  The scalar arithmetic (bias corrections, schedule, clip scale) is
done in float32 tensors, as JAX does it, not in Python doubles.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.distributed.sharding import TensorSpec


class AdamWState(NamedTuple):
    step: Any           # () int32
    m: Any              # param-tree
    v: Any              # param-tree


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def state_specs(param_specs) -> AdamWState:
    def zeros_like_spec(s: TensorSpec) -> TensorSpec:
        return TensorSpec(s.shape, s.axes, torch.float32, init="zeros")
    return AdamWState(
        step=TensorSpec((), (), torch.int32, init="zeros"),
        m=tu.tree_map(zeros_like_spec, param_specs),
        v=tu.tree_map(zeros_like_spec, param_specs),
    )


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * frac))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tu.leaves(tree)))


def update(cfg: AdamWConfig, grads, state: AdamWState, params):
    """Returns (new_params, new_state, metrics)."""
    step = state.step + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(_f32(cfg.beta1, step), step.float())
    b2c = 1 - torch.pow(_f32(cfg.beta2, step), step.float())

    def upd(p, g, m, v):
        g = g.float() * scale
        m = cfg.beta1 * m + (1 - cfg.beta1) * g
        v = cfg.beta2 * v + (1 - cfg.beta2) * torch.square(g)
        mh = m / b1c
        vh = v / b2c
        step_vec = mh / (torch.sqrt(vh) + cfg.eps)
        if p.dim() >= 2:  # decoupled weight decay on matrices only
            step_vec = step_vec + cfg.weight_decay * p.float()
        return (p.float() - lr * step_vec).to(p.dtype), m, v

    keys = [k for k, _ in tu.flatten_with_keys(params)]
    new = [upd(p, g, m, v) for p, g, m, v in
           zip(tu.leaves(params), tu.leaves(grads), tu.leaves(state.m),
               tu.leaves(state.v))]

    def pick(i):
        return tu.unflatten_like(params, {k: n[i] for k, n in zip(keys, new)})
    metrics = {"grad_norm": gnorm, "lr": lr}
    return pick(0), AdamWState(step, pick(1), pick(2)), metrics
