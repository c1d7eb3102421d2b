"""Public model API: specs, train state, the evaluation loss and the
prefill and decode steps of the serving path.

``TrainState``/``AdamWState`` are NamedTuples in the reference's field
order, so the state flattens to the reference's snapshot keys
(``.params[...]``, ``.opt.step``, ``.opt.m[...]``, ``.opt.v[...]``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import lm
from repro_torch.models.layers import softmax_cross_entropy
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWState


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


def _require_trainable(cfg: ArchConfig) -> None:
    """The SSM and hybrid families serve but do not train yet: the scan
    kernel has no backward (nor has the reference's)."""
    if cfg.family in ("ssm", "hybrid"):
        raise NotImplementedError(f"training the {cfg.family} family is "
                                  "not yet ported to repro_torch")


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
    _require_trainable(cfg)

    def eval_loss(params, batch: dict):
        tokens = _on(params, batch["tokens"])
        labels = _on(params, batch["labels"])
        logits, _ = lm.forward_train(params, cfg, tokens, run)
        return softmax_cross_entropy(logits, labels, cfg.vocab_size)
    return eval_loss
