"""The reference's own granite cells on a (2, 2) CPU mesh, for
``tests/test_torch_mesh.py``: run as a script in a process of its own,
whose ``XLA_FLAGS`` give the CPU four devices, as the reference's dry run
sets its device count.

    python tests/jax_mesh_cell.py OUT.npz SEQ_LEN BATCH

Writes the initial state (``jax.random.key(0)``), the train step's loss
and the prefill's logits, all float32 compute, to ``OUT.npz``."""
from __future__ import annotations

import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AxisType

from repro.configs.base import SHAPES, get_arch, reduced
from repro.core.snapshots import _flatten
from repro.distributed.sharding import init_tree
from repro.launch.cell import build_cell, concrete_batch
from repro.models import api
from repro.models.lm import RunConfig


def main(out: str, seq_len: int, batch: int) -> None:
    assert jax.device_count() == 4, jax.devices()
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto, AxisType.Auto))
    cfg = reduced(get_arch("granite-3-2b"))
    run = RunConfig(compute_dtype=jnp.float32)
    specs = api.state_specs(cfg)
    state = api.TrainState(init_tree(specs.params, jax.random.key(0)),
                           init_tree(specs.opt, jax.random.key(0)))
    flat = {k: np.asarray(v) for k, v in _flatten(state)}
    res = {}
    with mesh:
        for name in ("train_4k", "prefill_32k"):
            shape = dataclasses.replace(SHAPES[name], seq_len=seq_len,
                                        global_batch=batch)
            cell = build_cell(cfg, shape, mesh, run)
            b = concrete_batch(cfg, shape)
            if name == "train_4k":
                copy = jax.tree.map(jnp.array, state)
                _, metrics = cell.step(copy, b)
                res["loss"] = np.asarray(metrics["loss"])
            else:
                logits, _ = cell.step(state.params, b)
                res["logits"] = np.asarray(logits)
    np.savez(out, **res, **{"state:" + k: v for k, v in flat.items()})


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]))
