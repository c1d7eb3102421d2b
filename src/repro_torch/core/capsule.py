"""Compute Capsules — the "VM image" (paper §III-B).

A capsule is a hermetic, topology-free bundle: arch config + shape + run
config + a content-addressed manifest.  "Compile your application on a single
architecture" becomes *define once, instantiate on any volunteer mesh*:
``boot(spec, device_or_mesh)`` builds the step functions for one device
or, on a ``DeviceMesh``, under the sharding rules resolved for that mesh,
measuring boot time (the paper's <20 s VM boot requirement maps to
build+restore latency).

The manifest hash gives volunteers end-to-end integrity over what they run
(the paper's trusted-application concern), and the V-BOINC *server*
(core/server.py) distributes capsules exactly like VM images.  The
manifest is the reference's, key for key: the run config is written in
the reference's layout (its mesh knobs at their defaults, dtypes by
their numpy names), so a capsule published from either package is the
same content-addressed object.
"""
from __future__ import annotations

import dataclasses
import json
import time
from dataclasses import dataclass
from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, get_arch
from repro_torch.core.chunkstore import sha256
from repro_torch.distributed.sharding import ShardingRules
from repro_torch.kernels.delta_encode.ops import dtype_name
from repro_torch.launch import mesh as mesh_mod
from repro_torch.launch.cell import cell_rules, with_rules
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.optim import adamw

# the reference's RunConfig knobs, at the reference's defaults (the
# port's own): they are part of the manifest and so of its hash
REFERENCE_RUN_DEFAULTS = {
    "logical_rules": RunConfig.logical_rules,
    "fsdp_gather_weights": RunConfig.fsdp_gather_weights}


@dataclass(frozen=True)
class CapsuleSpec:
    arch_name: str
    shape_name: str
    run: RunConfig
    version: str = "1"
    # reduced override for CPU smoke capsules (None = full assigned config)
    arch_override: Optional[ArchConfig] = None

    def manifest(self) -> dict:
        run = {**REFERENCE_RUN_DEFAULTS, **dataclasses.asdict(self.run)}
        run["compute_dtype"] = dtype_name(self.run.compute_dtype)
        m = {"arch": self.arch_name, "shape": self.shape_name,
             "run": run, "version": self.version}
        if self.arch_override is not None:
            m["arch_override"] = dataclasses.asdict(self.arch_override)
        return m

    @property
    def manifest_hash(self) -> str:
        return sha256(json.dumps(self.manifest(), sort_keys=True,
                                 default=str).encode())

    @property
    def arch(self) -> ArchConfig:
        return self.arch_override or get_arch(self.arch_name)

    @property
    def shape(self) -> ShapeConfig:
        return SHAPES[self.shape_name]


@dataclass
class BootedCapsule:
    spec: CapsuleSpec
    grad_fn: Callable              # (params, batch) -> (loss, grads)
    apply_fn: Callable             # (state, grads) -> state (AdamW)
    boot_wall_s: float             # "VM boot time"
    device_desc: str
    rules: Optional[ShardingRules] = None   # on a mesh: place state by

    def step(self, state, batch):
        """One optimizer step: -> (new state, loss)."""
        loss, grads = self.grad_fn(state.params, batch)
        return self.apply_fn(state, grads), loss


def boot(spec: CapsuleSpec, device_or_mesh, *,
         verify_hash: Optional[str] = None) -> BootedCapsule:
    """Instantiate a capsule on a device or a ``DeviceMesh`` (any
    topology).

    ``verify_hash`` rejects a tampered capsule before any compute runs —
    the volunteer-side trust check.  A ``cuda`` device needs a card.  On
    a mesh the steps run under the rules ``launch.cell`` resolves for the
    capsule's shape there, and take state placed by them (``rules``:
    ``init_tree``/``restore`` with ``rules=``); ``device_desc`` is the
    reference's ``mesh_desc``, e.g. "2x2:data,model"."""
    if verify_hash is not None and verify_hash != spec.manifest_hash:
        raise PermissionError("capsule manifest hash mismatch — refusing to "
                              "boot untrusted image")
    rules = None
    if isinstance(device_or_mesh, DeviceMesh):
        rules = cell_rules(device_or_mesh, spec.shape, spec.run)
        desc = mesh_mod.mesh_desc(device_or_mesh)
    else:
        dev = torch.device(device_or_mesh)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device available to boot the "
                               "capsule on")
        desc = str(dev) if dev.type != "cuda" \
            else f"{dev}:{torch.cuda.get_device_name(dev)}"
    t0 = time.time()
    grad_fn = api.make_grad_fn(api.make_eval_loss(spec.arch, spec.run))
    oc = adamw.AdamWConfig()

    def apply_fn(state, grads):
        p, o, _ = adamw.update(oc, grads, state.opt, state.params)
        return api.TrainState(p, o)

    if rules is not None:
        grad_fn, apply_fn = (with_rules(f, rules) for f in (grad_fn,
                                                             apply_fn))
    return BootedCapsule(spec, grad_fn, apply_fn, time.time() - t0, desc,
                         rules)
