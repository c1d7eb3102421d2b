"""Public model API: specs, train state, the train step, the evaluation
loss and the prefill and decode steps of the serving path.

``TrainState``/``AdamWState`` are NamedTuples in the reference's field
order, so the state flattens to the reference's snapshot keys
(``.params[...]``, ``.opt.step``, ``.opt.m[...]``, ``.opt.v[...]``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def param_specs(cfg: ArchConfig):
    _require_decoder_only(cfg)
    return lm.lm_specs(cfg)


def state_specs(cfg: ArchConfig) -> TrainState:
    ps = param_specs(cfg)
    return TrainState(params=ps, opt=adamw.state_specs(ps))


def cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    _require_decoder_only(cfg)
    return lm.cache_specs(cfg, batch, max_len)


def _require_decoder_only(cfg: ArchConfig) -> None:
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder models are not yet "
                                  "ported to repro_torch")


def _on(params, x) -> torch.Tensor:
    """A batch entry (numpy array, list or tensor) on the params' device."""
    return torch.as_tensor(x, device=params["embed"].device)


def make_prefill_step(cfg: ArchConfig, max_len: int,
                      run: RunConfig = RunConfig()):
    _require_decoder_only(cfg)

    def prefill_step(params, batch: dict):
        return lm.prefill(params, cfg, _on(params, batch["tokens"]),
                          max_len, run)
    return prefill_step


def make_decode_step(cfg: ArchConfig, run: RunConfig = RunConfig()):
    _require_decoder_only(cfg)

    def decode_step(params, caches, batch: dict):
        return lm.decode_step(params, cfg, caches,
                              _on(params, batch["tokens"]),
                              _on(params, batch["index"]), run)
    return decode_step


def make_eval_loss(cfg: ArchConfig, run: RunConfig = RunConfig()):
    """-> loss(params, batch): mean token cross-entropy.  ``batch`` holds
    ``tokens``/``labels`` (B, T) int arrays or tensors; they are moved to
    the params' device."""
    _require_decoder_only(cfg)

    def eval_loss(params, batch: dict):
        tokens = _on(params, batch["tokens"])
        labels = _on(params, batch["labels"])
        logits, _ = lm.forward_train(params, cfg, tokens, run)
        return softmax_cross_entropy(logits, labels, cfg.vocab_size)
    return eval_loss


def make_grad_fn(loss_fn, has_aux: bool = False):
    """``jax.value_and_grad`` over a param tree: -> grad_fn(params, batch)
    -> (value, grads), autograd over detached leaves.  ``value`` is the
    loss, or with ``has_aux`` the pair (loss, aux) ``loss_fn`` returns,
    all detached."""
    def grad_fn(params, batch):
        keys = [k for k, _ in tu.flatten_with_keys(params)]
        leaves = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
        live = tu.unflatten_like(params, dict(zip(keys, leaves)))
        out = loss_fn(live, batch)
        loss = out[0] if has_aux else out
        grads = tu.unflatten_like(params, dict(zip(
            keys, torch.autograd.grad(loss, leaves))))
        value = tu.tree_map(lambda a: a.detach(), out)
        return value, grads
    return grad_fn


def make_train_step(cfg: ArchConfig, run: RunConfig = RunConfig(),
                    opt_cfg: AdamWConfig = AdamWConfig()):
    """-> train_step(state, batch) -> (new state, metrics): the loss (an
    MoE's with ``router_aux_coef`` x its load-balance loss and 1e-3 x its
    z-loss added), its gradient and one AdamW update, as the reference's.
    ``metrics`` holds the model's metrics, ``loss``, ``grad_norm`` and
    ``lr``."""
    _require_decoder_only(cfg)
    vocab = cfg.vocab_size

    def loss_fn(params, batch):
        logits, metrics = lm.forward_train(
            params, cfg, _on(params, batch["tokens"]), run)
        loss = softmax_cross_entropy(logits, _on(params, batch["labels"]),
                                     vocab)
        if "moe_aux" in metrics:
            loss = loss + cfg.moe.router_aux_coef * metrics["moe_aux"] \
                + 1e-3 * metrics["moe_zloss"]
        return loss, metrics

    grad_fn = make_grad_fn(loss_fn, has_aux=True)

    def train_step(state: TrainState, batch: dict):
        (loss, metrics), grads = grad_fn(state.params, batch)
        new_params, new_opt, opt_metrics = adamw.update(
            opt_cfg, grads, state.opt, state.params)
        metrics = dict(metrics, loss=loss, **opt_metrics)
        return TrainState(new_params, new_opt), metrics
    return train_step
