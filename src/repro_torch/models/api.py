"""Public model API: specs, input specs, train state, the train step, the
evaluation loss and the prefill and decode steps of the serving path, for
the decoder-only families (``lm``) and the encoder–decoder (``encdec``),
whose batches also carry ``frames``.

``TrainState``/``AdamWState`` are NamedTuples in the reference's field
order, so the state flattens to the reference's snapshot keys
(``.params[...]``, ``.opt.step``, ``.opt.m[...]``, ``.opt.v[...]``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.distributed.sharding import TensorSpec
from repro_torch.models import encdec, lm
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig, AdamWState


class TrainState(NamedTuple):
    params: Any
    opt: AdamWState


def param_specs(cfg: ArchConfig):
    return encdec.encdec_specs(cfg) if cfg.enc_dec else lm.lm_specs(cfg)


def state_specs(cfg: ArchConfig) -> TrainState:
    ps = param_specs(cfg)
    return TrainState(params=ps, opt=adamw.state_specs(ps))


def cache_specs(cfg: ArchConfig, batch: int, max_len: int):
    if cfg.enc_dec:
        return encdec.encdec_cache_specs(cfg, batch, max_len)
    return lm.cache_specs(cfg, batch, max_len)


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> dict:
    """``TensorSpec`` stand-ins for every input of a step at ``shape``.

    Modality frontends are stubs, as in the reference: audio provides
    precomputed frame embeddings; chameleon's VQ ids live in the shared
    vocab so its inputs are ordinary token ids."""
    b, t = shape.global_batch, shape.seq_len

    def tok(*s):
        return TensorSpec(tuple(s), ("batch",) + (None,) * (len(s) - 1),
                          torch.int32)

    if shape.kind == "decode":
        # one new token against a cache of length t
        return {"tokens": tok(b, 1), "index": TensorSpec((), (), torch.int32)}
    out = {"tokens": tok(b, t)}
    if shape.kind == "train":
        out["labels"] = tok(b, t)
    if cfg.enc_dec:
        out["frames"] = TensorSpec((b, t, cfg.d_model),
                                   ("batch", None, "embed"), torch.float32)
    return out


def _on(params, x) -> torch.Tensor:
    """A batch entry (numpy array, list or tensor) on the params' device."""
    return torch.as_tensor(x, device=params["embed"].device)


def _forward_train(cfg: ArchConfig, run: RunConfig, params, batch: dict):
    """The family's training forward on ``batch`` -> (logits, metrics)."""
    tokens = _on(params, batch["tokens"])
    if cfg.enc_dec:
        return encdec.forward_train(params, cfg,
                                    _on(params, batch["frames"]), tokens,
                                    run)
    return lm.forward_train(params, cfg, tokens, run)


def make_prefill_step(cfg: ArchConfig, max_len: int,
                      run: RunConfig = RunConfig()):
    def prefill_step(params, batch: dict):
        tokens = _on(params, batch["tokens"])
        if cfg.enc_dec:
            return encdec.prefill(params, cfg, _on(params, batch["frames"]),
                                  tokens, max_len, run)
        return lm.prefill(params, cfg, tokens, max_len, run)
    return prefill_step


def make_decode_step(cfg: ArchConfig, run: RunConfig = RunConfig()):
    fn = encdec.decode_step if cfg.enc_dec else lm.decode_step

    def decode_step(params, caches, batch: dict):
        return fn(params, cfg, caches, _on(params, batch["tokens"]),
                  _on(params, batch["index"]), run)
    return decode_step


def make_eval_loss(cfg: ArchConfig, run: RunConfig = RunConfig()):
    """-> loss(params, batch): mean token cross-entropy.  ``batch`` holds
    ``tokens``/``labels`` (B, T) int arrays or tensors, and for an
    encoder–decoder ``frames`` (B, S, D); they are moved to the params'
    device."""
    def eval_loss(params, batch: dict):
        logits, _ = _forward_train(cfg, run, params, batch)
        return softmax_cross_entropy(logits, _on(params, batch["labels"]),
                                     cfg.vocab_size)
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
    vocab = cfg.vocab_size

    def loss_fn(params, batch):
        logits, metrics = _forward_train(cfg, run, params, batch)
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
