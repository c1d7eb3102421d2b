"""Port parity for training the SSM and hybrid families.

``reduced(falcon-mamba-7b)`` and ``reduced(hymba-1.5b)`` with JAX
``init_tree`` params carried across by ``repro_torch.convert``.  Both
sides differentiate their chunked associative scan (the reference has no
backward kernel; the port's ``ssm_scan`` kernel stays on prefill), the
port's with a short last chunk where the reference pads with identity
elements, so T runs both as a multiple of ``ssm_chunk`` (16 at chunk 8)
and not (21).  Tolerances, as ``tests/test_torch_model.py``:

* float32: 1e-5, relative, with an absolute floor of 1e-5 of the largest
  value: the same arithmetic in another order (the port's doubling scan
  against ``lax.associative_scan``);
* bfloat16: 2e-2 of the largest value: the frameworks round bf16
  intermediates at different places.

``make_train_step`` is held in float32: loss and metrics within 1e-5, the
params after one AdamW update within 1e-5 of the largest param.  The
launcher trains these families, and the MoE's, with every flag;
``--uplink --compress-grads`` runs here for each.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.data.pipeline import DataConfig, TokenStream
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.kernels.ssm_scan.kernel import ssm_scan
from repro_torch.launch import train
from repro_torch.models import api
from repro_torch.models.lm import RunConfig

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
CHUNK = 8
RTOL = 1e-5


def _cfg(arch):
    return reduced(get_arch(arch))


def _close(got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = floor * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _runs(dtype):
    return (JRunConfig(remat="none", ssm_chunk=CHUNK,
                       compute_dtype=getattr(jnp, dtype)),
            RunConfig(remat="none", ssm_chunk=CHUNK,
                      compute_dtype=getattr(torch, dtype)))


@pytest.mark.parametrize("seq", [2 * CHUNK, 2 * CHUNK + 5])
@pytest.mark.parametrize("dtype,rtol,floor", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 2e-2, 2e-2),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, rtol, floor, seq):
    cfg = _cfg(arch)
    jparams = j_init_tree(japi.param_specs(cfg), jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in j_flatten(jparams)}
    batch = TokenStream(DataConfig(cfg.vocab_size, seq, 2, seed=0)).batch(0)
    jrun, run = _runs(dtype)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        japi.make_eval_loss(cfg, jrun)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    before = ssm_scan.launches
    tloss, tgrads = api.make_grad_fn(api.make_eval_loss(cfg, run))(
        convert.tree_from_numpy(flat, "cpu"), batch)
    assert ssm_scan.launches == before      # training runs the jnp twin
    _close(float(tloss), float(jloss), rtol, 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads)}
    got = dict(tu.flatten_with_keys(tgrads))
    assert list(got) == list(want)
    for key, g in want.items():
        _close(got[key].float().numpy(), g, rtol, floor)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    cfg = _cfg(arch)
    specs = japi.state_specs(cfg)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in j_flatten(jstate)}, "cpu")
    batch = TokenStream(DataConfig(cfg.vocab_size, 2 * CHUNK + 5, 2,
                                   seed=1)).batch(0)
    jrun, run = _runs("float32")
    jnew, jm = jax.jit(japi.make_train_step(cfg, jrun))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = api.make_train_step(cfg, run)(state, batch)
    assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
    for key in jm:
        _close(float(m[key]), float(jm[key]), RTOL, 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jnew)}
    got = dict(tu.flatten_with_keys(new))
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key].numpy(), w, 0.0, RTOL)


@pytest.mark.parametrize("arch", ARCHS + ["deepseek-moe-16b"])
def test_uplink_launcher_trains_every_family(arch):
    """``--uplink --compress-grads``: 4 units over 2 rounds, each accepted
    by the project server, with a snapshot a round."""
    out = train.main(["--device", "cpu", "--arch", arch, "--uplink",
                      "--compress-grads", "--steps", "2",
                      "--snapshot-every", "1"])
    assert out["uplink"]["accepted"] == 4
    assert out["uplink"]["rejected"] == 0
    assert all(np.isfinite(out["losses"]))
    assert out["store"]["put_chunks"] > 0
