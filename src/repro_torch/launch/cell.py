"""Build one (arch × shape × device) "cell": its step function, its
arguments and their specs (the counterpart of ``repro.launch.cell``).

The dry run, the smoke run's ``cells`` phase and the tests build their
cells here, so what they trace and what they run is one step.  On the
``meta`` device the arguments are ``abstract_tree``s of the specs (no
storage); on any other device they are concrete: params and optimizer
state from ``init_tree`` with a seeded generator, zero caches, and
``concrete_batch``'s numpy inputs.

The reference's ``ShardingRules``, its inference-only rule override and
``use_rules`` around the step have no counterpart: on one card every
tensor is whole.  Its ``jax.jit`` with donated arguments becomes the eager
step itself; ``donated`` names the arguments whose memory the outputs
take over (the train state, a decode cache), as ``donate_argnums`` did.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.distributed.sharding import (TensorSpec, abstract_tree,
                                              init_tree)
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim.adamw import AdamWConfig


@dataclass
class Cell:
    arch: ArchConfig
    shape: ShapeConfig
    device: torch.device
    step: Callable
    args: tuple               # what ``step(*args)`` takes
    kind: str
    arg_specs: tuple          # a spec tree per argument
    out_specs: tuple          # a spec tree per output (metrics left out)
    donated: tuple = ()       # indexes of args the outputs take over


def _logits_spec(arch: ArchConfig, shape: ShapeConfig,
                 run: RunConfig) -> TensorSpec:
    b, vp = shape.global_batch, arch.padded_vocab()
    dims = (b, vp) if shape.kind == "prefill" else (b, 1, vp)
    return TensorSpec(dims, (None,) * len(dims), run.compute_dtype)


def build_cell(arch: ArchConfig, shape: ShapeConfig, device,
               run: RunConfig = RunConfig()) -> Cell:
    """The step of ``shape.kind`` at ``shape`` on ``device``, chosen as the
    reference chooses: ``make_train_step`` (with the default
    ``AdamWConfig``), ``make_prefill_step`` to ``seq_len`` or
    ``make_decode_step`` against a cache of ``seq_len``.  Concrete
    arguments come from seed 0."""
    ok, why = shape_applicable(arch, shape)
    if not ok:
        raise ValueError(why)
    device = torch.device(device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(0)

    def params_of(specs):
        return abstract_tree(specs) if meta else \
            init_tree(specs, gen, device=device)

    def zeros_of(specs):
        return abstract_tree(specs) if meta else tu.tree_map(
            lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device),
            specs)

    in_specs = api.input_specs(arch, shape)
    if meta:
        batch = abstract_tree(in_specs)
    else:
        batch = {k: torch.as_tensor(v, device=device) for k, v in
                 concrete_batch(arch, shape).items()}

    if shape.kind == "train":
        specs = api.state_specs(arch)
        state = api.TrainState(params_of(specs.params),
                               params_of(specs.opt))
        return Cell(arch, shape, device,
                    api.make_train_step(arch, run, AdamWConfig()),
                    (state, batch), "train", (specs, in_specs), (specs,),
                    donated=(0,))

    param_specs = api.param_specs(arch)
    params = params_of(param_specs)
    cache_specs = api.cache_specs(arch, shape.global_batch, shape.seq_len)
    logits = _logits_spec(arch, shape, run)
    if shape.kind == "prefill":
        return Cell(arch, shape, device,
                    api.make_prefill_step(arch, shape.seq_len, run),
                    (params, batch), "prefill", (param_specs, in_specs),
                    (logits, cache_specs))
    return Cell(arch, shape, device, api.make_decode_step(arch, run),
                (params, zeros_of(cache_specs), batch), "decode",
                (param_specs, cache_specs, in_specs),
                (logits, cache_specs), donated=(1,))


def concrete_batch(arch: ArchConfig, shape: ShapeConfig,
                   seed: int = 0) -> dict:
    """Concrete host-side inputs for smoke/bench runs (small shapes only):
    the reference's numpy draws, bit for bit."""
    b = shape.global_batch
    t = shape.seq_len
    rng = np.random.default_rng(seed)
    if shape.kind == "train":
        out = {"tokens": rng.integers(0, arch.vocab_size, (b, t), dtype=np.int64).astype(np.int32),
               "labels": rng.integers(0, arch.vocab_size, (b, t), dtype=np.int64).astype(np.int32)}
    elif shape.kind == "prefill":
        out = {"tokens": rng.integers(0, arch.vocab_size, (b, t), dtype=np.int64).astype(np.int32)}
    else:
        out = {"tokens": rng.integers(0, arch.vocab_size, (b, 1), dtype=np.int64).astype(np.int32),
               "index": np.int32(t - 1)}
    if arch.enc_dec and shape.kind in ("train", "prefill"):
        out["frames"] = rng.standard_normal((b, t, arch.d_model)).astype(np.float32)
    return out
