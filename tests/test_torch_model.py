"""Port parity for the dense model on the training path.

``reduced(granite-3-2b)`` with JAX-initialised params carried across by
``repro_torch.convert``: loss and every gradient against
``jax.value_and_grad(make_eval_loss)``.  Tolerances:

* float32 compute: 1e-5 (relative, with an absolute floor of 1e-5 of the
  largest gradient) — both sides do the same f32 arithmetic and differ
  only in summation order;
* bfloat16 compute: 2e-2 of the largest value — the two frameworks round
  bf16 intermediates at different places, so single elements may differ
  by a few bf16 ulps.

The primitives are also held one by one against the reference in f32 at
1e-5: ``rms_norm``, ``rotary``, ``blocked_attention`` (causal, sliding
window, ``kv_len`` and a ragged last block), ``swiglu`` and
``softmax_cross_entropy`` over a padded vocab.
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
from repro.models import layers as jl
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.models import api, layers
from repro_torch.models.lm import RunConfig

CFG = reduced(get_arch("granite-3-2b"), n_layers=2, vocab_size=300)


def _close(got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = floor * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def params_and_batch():
    specs = japi.state_specs(CFG)
    jparams = j_init_tree(specs.params, jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in j_flatten(jparams)}
    batch = TokenStream(DataConfig(CFG.vocab_size, 16, 2, seed=0)).batch(0)
    return jparams, flat, batch


@pytest.mark.parametrize("dtype,rtol,floor", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 2e-2, 2e-2),
])
def test_loss_and_grads_match_reference(params_and_batch, dtype, rtol,
                                        floor):
    jparams, flat, batch = params_and_batch
    jrun = JRunConfig(remat="none", compute_dtype=getattr(jnp, dtype))
    jloss, jgrads = jax.jit(jax.value_and_grad(japi.make_eval_loss(CFG, jrun)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = convert.tree_from_numpy(flat, "cpu")
    run = RunConfig(remat="none", compute_dtype=getattr(torch, dtype))
    tloss, tgrads = api.make_grad_fn(api.make_eval_loss(CFG, run))(tparams,
                                                               batch)
    _close(float(tloss), float(jloss), rtol, 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads)}
    got = dict(tu.flatten_with_keys(tgrads))
    assert list(got) == list(want)
    for key, g in want.items():
        _close(got[key].numpy(), g, rtol, floor)


def test_remat_gives_the_same_grads(params_and_batch):
    _, flat, batch = params_and_batch
    tparams = convert.tree_from_numpy(flat, "cpu")
    out = []
    for remat in ("none", "full"):
        run = RunConfig(remat=remat, compute_dtype=torch.float32)
        out.append(api.make_grad_fn(api.make_eval_loss(CFG, run))(tparams,
                                                                  batch))
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(tu.leaves(out[0][1]), tu.leaves(out[1][1])):
        assert torch.equal(a, b)


# ---------------------------------------------------------- primitives
RTOL = 1e-5


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_rms_norm_and_swiglu():
    rng = np.random.default_rng(0)
    x, w = _rand(rng, 2, 5, 16), _rand(rng, 16)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(w)).numpy(),
           jl.rms_norm(jnp.asarray(x), jnp.asarray(w)), RTOL, 1e-6)
    wg, wu, wd = _rand(rng, 16, 24), _rand(rng, 16, 24), _rand(rng, 24, 16)
    got = layers.swiglu(*map(torch.from_numpy, (x, wg, wu, wd)))
    _close(got.numpy(), jl.swiglu(*map(jnp.asarray, (x, wg, wu, wd))),
           RTOL, 1e-6)


def test_rotary():
    rng = np.random.default_rng(1)
    x = _rand(rng, 2, 7, 3, 16)
    pos = np.broadcast_to(np.arange(7, dtype=np.int32) * 3, (2, 7)).copy()
    got = layers.rotary(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    _close(got.numpy(), jl.rotary(jnp.asarray(x), jnp.asarray(pos), 1e4),
           RTOL, 1e-6)


@pytest.mark.parametrize("causal,window,block_kv,kv_len,q_offset", [
    (True, 0, 8, None, 0),
    (True, 5, 8, None, 0),            # sliding window
    (False, 0, 7, None, 0),           # ragged last KV block
    (False, 0, 8, (20, 9), 0),        # per-sequence valid lengths
    (True, 4, 6, (20, 13), 3),        # all together, offset queries
])
def test_blocked_attention(causal, window, block_kv, kv_len, q_offset):
    rng = np.random.default_rng(2)
    q, k, v = _rand(rng, 2, 12, 4, 8), _rand(rng, 2, 20, 4, 8), \
        _rand(rng, 2, 20, 4, 8)
    kl = None if kv_len is None else np.asarray(kv_len, np.int32)
    want = jl.blocked_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        q_offset=q_offset, window=window, block_kv=block_kv,
        kv_len=None if kl is None else jnp.asarray(kl))
    got = layers.blocked_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, q_offset=q_offset, window=window, block_kv=block_kv,
        kv_len=None if kl is None else torch.from_numpy(kl))
    _close(got.numpy(), want, RTOL, 1e-6)


def test_repeat_kv():
    rng = np.random.default_rng(3)
    k = _rand(rng, 2, 5, 2, 4)
    np.testing.assert_array_equal(
        layers.repeat_kv(torch.from_numpy(k), 3).numpy(),
        np.asarray(jl.repeat_kv(jnp.asarray(k), 3)))


def test_softmax_cross_entropy_padded_vocab():
    rng = np.random.default_rng(4)
    logits = _rand(rng, 2, 6, 128) * 3
    labels = rng.integers(0, 100, (2, 6)).astype(np.int32)
    got = layers.softmax_cross_entropy(torch.from_numpy(logits),
                                       torch.from_numpy(labels), 100)
    want = jl.softmax_cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                    100)
    _close(float(got), float(want), RTOL, 0.0)
