"""Public model API: specs, train state and the evaluation loss.

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
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder models are not yet "
                                  "ported to repro_torch")
    return lm.lm_specs(cfg)


def state_specs(cfg: ArchConfig) -> TrainState:
    ps = param_specs(cfg)
    return TrainState(params=ps, opt=adamw.state_specs(ps))


def make_eval_loss(cfg: ArchConfig, run: RunConfig = RunConfig()):
    """-> loss(params, batch): mean token cross-entropy.  ``batch`` holds
    ``tokens``/``labels`` (B, T) int arrays or tensors; they are moved to
    the params' device."""
    if cfg.enc_dec:
        raise NotImplementedError("encoder-decoder models are not yet "
                                  "ported to repro_torch")

    def eval_loss(params, batch: dict):
        dev = params["embed"].device
        tokens = torch.as_tensor(batch["tokens"], device=dev)
        labels = torch.as_tensor(batch["labels"], device=dev)
        logits, _ = lm.forward_train(params, cfg, tokens, run)
        return softmax_cross_entropy(logits, labels, cfg.vocab_size)
    return eval_loss
