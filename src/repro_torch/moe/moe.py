"""Mixture-of-Experts block (DeepSeekMoE / Qwen3-MoE style).

The reference's dispatch (``repro.moe.moe``): the (token, slot)
pairs of each batch row are sorted by expert id (a stable sort, as
``jnp.argsort``'s, so the first ``capacity`` pairs of an expert in token
order are the ones kept), gathered into a dense (B, E, C, D) buffer, run
through the expert SwiGLUs as batched products, and added back to their
tokens weighted by their gates.  Over-capacity pairs are dropped per
(row, expert); the drop fraction is a metric, beside the switch-style
load-balance loss and the router z-loss.

The combine differs in form only: each token gathers its k items back
through the inverse of the sort and sums them, where the reference
scatter-adds the items into their tokens.  The forward then has no
scatter: on the card a scatter-add under
``torch.use_deterministic_algorithms`` (which the train launcher turns
on) runs as a sort, and took most of an MoE prefill's device time.
Every gather is ``index_select`` on flat indices or ``gather``; their
backward passes and the integer ``cumsum`` of the offsets have
deterministic implementations in that mode.  The expert products are
plain batched products (``bmm``), as the reference computes them outside
any Pallas kernel.
"""
from __future__ import annotations

import functools
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Replicate

from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.sharding import TensorSpec, constrain, run_local
from repro_torch.models import layers


def moe_specs(cfg: ArchConfig) -> dict:
    d = cfg.d_model
    e, fe = cfg.moe.n_experts, cfg.moe.d_ff_expert
    out = {
        "router": TensorSpec((d, e), ("embed", None)),
        "w_gate": TensorSpec((e, d, fe), ("experts", "embed", "expert_ff")),
        "w_up": TensorSpec((e, d, fe), ("experts", "embed", "expert_ff")),
        "w_down": TensorSpec((e, fe, d), ("experts", "expert_ff", "embed")),
    }
    if cfg.moe.n_shared_experts:
        out["shared"] = layers.mlp_specs(
            d, cfg.moe.n_shared_experts * fe)
    return out


def _route(x: torch.Tensor, probs: torch.Tensor, e: int, k: int,
           cap: int):
    """Each batch row's dispatch, row by row: x (B, T, D), probs (B, T, E)
    -> (xin (B, E, C, D), counts (B, E), keep (B, I) in sorted order, and
    per (token, slot) pair in token order its gate (0 where dropped) and
    its slot in the row's (E * C) buffer).  Every index stays inside its
    row, so a batch shard's rows route alone."""
    b, t, d = x.shape
    n_items = t * k                                    # per-row (token,slot)s
    dev = x.device
    # on an exact tie jax.lax.top_k puts the lower expert first, and
    # torch.topk promises no order; router logits from random weights do
    # not tie exactly, so the two pick the same experts
    gate_vals, expert_ids = torch.topk(probs, k, dim=-1)          # (B,T,k)
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)                 # renormalize
    flat_expert = expert_ids.reshape(b, n_items)                  # (B,I)
    counts = F.one_hot(flat_expert, e).sum(1)                     # (B,E) int

    # ---- grouped (per batch row) sort-based dispatch ----
    flat_token = torch.arange(t, device=dev).repeat_interleave(k) \
        .expand(b, n_items)
    order = torch.argsort(flat_expert, dim=-1, stable=True)
    sorted_expert = torch.gather(flat_expert, 1, order)
    sorted_token = torch.gather(flat_token, 1, order)

    offsets = torch.cumsum(counts, -1) - counts                   # (B,E)
    rank = torch.arange(n_items, device=dev) - torch.gather(
        offsets, 1, sorted_expert)                                # (B,I)
    keep = rank < cap                                             # capacity

    # gather tokens into the (B, E, C, D) expert buffer
    slots = torch.arange(cap, device=dev)
    slot_pos = torch.clamp(offsets[:, :, None] + slots, 0, n_items - 1)
    slot_valid = slots < torch.clamp(counts, max=cap)[:, :, None]  # (B,E,C)
    tok_for_slot = torch.gather(sorted_token, 1,
                                slot_pos.reshape(b, e * cap))     # (B,E*C)
    rows = torch.arange(b, device=dev)[:, None]
    xin = x.reshape(b * t, d).index_select(
        0, (rows * t + tok_for_slot).reshape(-1)).reshape(b, e, cap, d) \
        * slot_valid[..., None].to(x.dtype)                       # (B,E,C,D)

    # where the reference scatter-adds each kept item into its token,
    # each token gathers its k items back through the sort's inverse
    item_slot = sorted_expert * cap + torch.clamp(rank, 0, cap - 1)
    inv = torch.argsort(order, dim=-1)          # (t, slot) -> its position
    weight = torch.where(torch.gather(keep, 1, inv),
                         gate_vals.reshape(b, n_items), 0.0)      # (B,I)
    return xin, counts, keep, weight, torch.gather(item_slot, 1, inv)


def _experts(xin: torch.Tensor, w_gate: torch.Tensor, w_up: torch.Tensor,
             w_down: torch.Tensor) -> torch.Tensor:
    """The expert SwiGLUs over the (B, E, C, D) buffer, as ``bmm``s over
    the expert dim of an (E, B*C, D) buffer (what ``einsum("becd,edf->
    becf")`` lowers to).  On a mesh the experts' split stays a split of
    the products' batch dim, and no product's backward views a gradient
    that DTensor left strided (which ``einsum``'s does)."""
    b, e, cap, d = xin.shape
    x = xin.permute(1, 0, 2, 3).reshape(e, b * cap, d)
    h = F.silu(torch.bmm(x, w_gate)) * torch.bmm(x, w_up)
    return torch.bmm(h, w_down).reshape(e, b, cap, d).permute(1, 0, 2, 3)


def _combine(yexp: torch.Tensor, weight: torch.Tensor,
             slot_of: torch.Tensor, k: int) -> torch.Tensor:
    """Each token's k expert outputs, weighted by their gates (0 where
    dropped) and summed: the same sum as the reference's scatter-add with
    no scatter, whose deterministic form on the card is a sort.  yexp
    (B, E, C, D), weight and slot_of (B, T*k) -> (B, T, D)."""
    b, e, cap, d = yexp.shape
    rows = torch.arange(b, device=yexp.device)[:, None]
    item_y = yexp.reshape(b * e * cap, d).index_select(
        0, (rows * (e * cap) + slot_of).reshape(-1))              # (B*I,D)
    return (item_y.reshape(b, -1, k, d)
            * weight.reshape(b, -1, k, 1).to(item_y.dtype)).sum(2)


def moe_apply(p: dict, x: torch.Tensor, cfg: ArchConfig,
              capacity_factor: float = 1.25) -> Tuple[torch.Tensor, dict]:
    """x: (B, T, D) -> (y, metrics).  Differentiable through gates.

    On DTensors (a cell on a mesh) the routing and the combine run on
    each rank's rows (``run_local``, the batch sharded, everything else
    whole), the expert products on the expert buffer constrained to the
    experts' axis, and the buffer's outputs are gathered back to their
    rows before the combine."""
    b, t, d = x.shape
    e, k = cfg.moe.n_experts, cfg.moe.top_k
    n_items = t * k                                    # per-row (token,slot)s
    cap = max(int(capacity_factor * n_items / e), 1)

    logits = x.float() @ p["router"].float()                      # (B,T,E)
    probs = torch.softmax(logits, dim=-1)
    route = functools.partial(_route, e=e, k=k, cap=cap)
    if isinstance(x, DTensor):
        rows = ("act_batch", None, None)
        x, probs = constrain(x, rows), constrain(probs, rows)
        pl = tuple(x.placements)
        pr = tuple(p if p.is_shard() else Replicate() for p in pl)
        xin, counts, keep, weight, slot_of = run_local(
            route, None, (pl, pl), (pr,) * 5, x, probs)
    else:
        xin, counts, keep, weight, slot_of = route(x, probs)

    # ---- aux losses (global means; cheap scalars) ----
    me = probs.mean((0, 1))                                       # (E,)
    ce = (counts.float() * (1.0 / (b * n_items))).sum(0)
    aux = e * torch.sum(me * ce)
    zloss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # expert MLPs — the only matmul FLOPs in this block (E sharded: EP)
    xin = constrain(xin, ("act_batch", "experts", None, None))
    dt = x.dtype
    ws = tuple(p[n].to(dt) for n in ("w_gate", "w_up", "w_down"))
    yexp = _experts(xin, *ws)

    combine = functools.partial(_combine, k=k)
    if isinstance(yexp, DTensor):
        yexp = constrain(yexp, ("act_batch", None, None, None))
        y = run_local(combine, None, (pr, pr, pr), pr, yexp, weight,
                      slot_of)
    else:
        y = combine(yexp, weight, slot_of)
    y = constrain(y, ("act_batch", "act_seq", "act_embed"))

    if "shared" in p:
        sh = p["shared"]
        y = y + layers.swiglu(x, sh["w_gate"], sh["w_up"], sh["w_down"])

    metrics = {
        "moe_aux": aux,
        "moe_zloss": zloss,
        # the reference's mean as XLA computes it, a product with 1/n
        "moe_drop_frac": 1.0 - keep.float().sum() * (1.0 / keep.numel()),
    }
    # whole on every rank: a scalar left as a pending partial sum has
    # no backward through the loss's add
    return y, {k: constrain(v, ()) for k, v in metrics.items()}
