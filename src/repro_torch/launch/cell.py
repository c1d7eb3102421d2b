"""Build one (arch × shape × mesh) "cell": its step function, its
arguments and their specs (the counterpart of ``repro.launch.cell``).

The dry run, the smoke run's ``cells`` and ``mesh`` phases and the tests
build their cells here, so what they trace and what they run is one
step.  On the ``meta`` device the arguments are ``abstract_tree``s of the
specs (no storage); on any other device they are concrete: params and
optimizer state from ``init_tree`` with a seeded generator, zero caches,
and ``concrete_batch``'s numpy inputs.

Given a ``DeviceMesh`` instead of a device, the cell resolves the
reference's ``ShardingRules`` on it (inference cells drop the FSDP
``embed`` rule, then ``rules_overrides``, then ``run.logical_rules``),
every argument is a DTensor at its resolved placements (meta DTensors
over the ``fake`` backend, else the unsharded cell's values distributed)
and the step runs inside ``use_rules``, so the models' ``constrain`` calls
bind to that mesh.  The reference's ``jax.jit`` with donated arguments
becomes the eager step itself; ``donated`` names the arguments whose
memory the outputs take over (the train state, a decode cache), as
``donate_argnums`` did.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch import tree as tu
from repro_torch.configs.base import ArchConfig, ShapeConfig, shape_applicable
from repro_torch.distributed.sharding import (ShardingRules, TensorSpec,
                                              abstract_tree, init_tree,
                                              use_rules)
from repro_torch.launch import mesh as mesh_mod
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
    mesh: Optional[DeviceMesh] = None
    rules: Optional[ShardingRules] = None


def _logits_spec(arch: ArchConfig, shape: ShapeConfig,
                 run: RunConfig) -> TensorSpec:
    b, vp = shape.global_batch, arch.padded_vocab()
    dims = (b, vp) if shape.kind == "prefill" else (b, 1, vp)
    return TensorSpec(dims, (None,) * len(dims), run.compute_dtype)


def cell_rules(mesh, shape: ShapeConfig, run: RunConfig,
               rules_overrides: Optional[dict] = None) -> ShardingRules:
    """The reference's rule table for a cell on ``mesh``."""
    rules = ShardingRules(mesh)
    if shape.kind != "train":
        # inference has no optimizer state: FSDP param sharding would only
        # add per-step all-gathers.  Keep params TP-sharded on the model
        # axis, DP-replicated.
        rules.rules["embed"] = None
    if rules_overrides:
        rules.rules.update(rules_overrides)
    if run.logical_rules:
        rules.rules.update(run.logical_rules)
    return rules


def with_rules(fn, rules: ShardingRules):
    """Activate the resolver around each call so ``constrain()`` calls in
    model code bind activation placements to THIS mesh."""
    def wrapped(*args):
        with use_rules(rules):
            return fn(*args)
    return wrapped


def build_cell(arch: ArchConfig, shape: ShapeConfig, mesh_or_device,
               run: RunConfig = RunConfig(),
               rules_overrides: Optional[dict] = None) -> Cell:
    """The step of ``shape.kind`` at ``shape`` on a device or a
    ``DeviceMesh``, chosen as the reference chooses: ``make_train_step``
    (with the default ``AdamWConfig``), ``make_prefill_step`` to
    ``seq_len`` or ``make_decode_step`` against a cache of ``seq_len``.
    Concrete arguments come from seed 0, drawn whole and (on a mesh)
    distributed, so a mesh cell holds the unsharded cell's values."""
    ok, why = shape_applicable(arch, shape)
    if not ok:
        raise ValueError(why)
    mesh = rules = None
    if isinstance(mesh_or_device, DeviceMesh):
        mesh = mesh_or_device
        rules = cell_rules(mesh, shape, run, rules_overrides)
        device = mesh_mod.tensor_device(mesh)
    else:
        device = torch.device(mesh_or_device)
    meta = device.type == "meta"
    gen = None if meta else torch.Generator(device=device).manual_seed(0)

    def params_of(specs):
        return abstract_tree(specs, rules) if meta else \
            init_tree(specs, gen, device=device, rules=rules)

    def placed(x, s: TensorSpec):
        return x if rules is None else rules.distribute(x, s)

    def zeros_of(specs):
        return abstract_tree(specs, rules) if meta else tu.tree_map(
            lambda s: placed(torch.zeros(s.shape, dtype=s.dtype,
                                         device=device), s), specs)

    in_specs = api.input_specs(arch, shape)
    if meta:
        batch = abstract_tree(in_specs, rules)
    else:
        batch = {k: placed(torch.as_tensor(v, device=device), in_specs[k])
                 for k, v in concrete_batch(arch, shape).items()}

    def cell(step, args, kind, arg_specs, out_specs, donated=()):
        if rules is not None:
            step = with_rules(step, rules)
        return Cell(arch, shape, device, step, args, kind, arg_specs,
                    out_specs, donated, mesh, rules)

    if shape.kind == "train":
        specs = api.state_specs(arch)
        state = api.TrainState(params_of(specs.params),
                               params_of(specs.opt))
        return cell(api.make_train_step(arch, run, AdamWConfig()),
                    (state, batch), "train", (specs, in_specs), (specs,),
                    donated=(0,))

    param_specs = api.param_specs(arch)
    params = params_of(param_specs)
    cache_specs = api.cache_specs(arch, shape.global_batch, shape.seq_len)
    logits = _logits_spec(arch, shape, run)
    if shape.kind == "prefill":
        return cell(api.make_prefill_step(arch, shape.seq_len, run),
                    (params, batch), "prefill", (param_specs, in_specs),
                    (logits, cache_specs))
    return cell(api.make_decode_step(arch, run),
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
