"""Port parity for the MoE family: ``repro_torch.moe.moe`` and the MoE
branches of the model, against the JAX package on the same inputs.

``reduced(deepseek-moe-16b)`` (a shared expert) and
``reduced(qwen3-moe-30b-a3b)`` (none, GQA, head_dim set) with JAX
``init_tree`` params carried across by ``repro_torch.convert``, inputs
from a numpy seed.  Tolerances:

* ``moe_apply`` in float32: outputs, ``moe_aux`` and ``moe_zloss`` within
  1e-5 (relative, with an absolute floor of 1e-5 of the largest value):
  the same f32 arithmetic in another summation order; ``moe_drop_frac``
  and the routing (which (token, expert) pairs are kept) equal, at
  capacity factors 0.5 (drops) and 8.0 (none) and the default 1.25;
* loss and gradients of ``make_eval_loss``, as
  ``tests/test_torch_model.py``: 1e-5 in float32, 2e-2 of the largest
  value in bfloat16 (the frameworks round bf16 intermediates at different
  places);
* ``make_train_step``: loss and metrics within 1e-5, and the params after
  one AdamW update within 1e-5 of the largest param.

The port's counterparts of ``tests/test_moe.py`` (dense mixture, bounded
drops, gradients reaching the router) hold it to a plain torch mixture.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import get_arch, reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.data.pipeline import DataConfig, TokenStream
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.models.lm import RunConfig as JRunConfig
from repro.moe import moe as jmoe
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.models import api
from repro_torch.models.lm import RunConfig
from repro_torch.moe import moe

ARCHS = ["deepseek-moe-16b", "qwen3-moe-30b-a3b"]
RTOL = 1e-5


def _cfg(arch):
    return reduced(get_arch(arch))


def _carried(jtree) -> dict:
    return convert.tree_from_numpy(
        {k: np.asarray(v) for k, v in j_flatten(jtree)}, "cpu")


def _close(got, want, rtol, floor):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    atol = floor * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _moe_params(cfg, seed=0):
    jp = j_init_tree(jmoe.moe_specs(cfg), jax.random.key(seed))
    return jp, _carried(jp)


def _x(cfg, b, t, seed=1) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(
        (b, t, cfg.d_model)).astype(np.float32)


def _kept(apply, p, x, w_down: str, grad):
    """(B, T, E) bool: whether token (b, t) reached expert e.  y is
    linear in each expert's ``w_down``, so a token's output has a
    gradient in expert e's slice exactly when one of its items was kept
    there (a gate is a softmax probability, never 0)."""
    b, t, _ = x.shape
    out = np.zeros((b, t, p["router"].shape[1]), bool)
    for i in range(b):
        for j in range(t):
            g = np.asarray(grad(lambda wd: apply(wd)[i, j].sum(), p[w_down]))
            out[i, j] = np.abs(g).reshape(g.shape[0], -1).max(1) > 0
    return out


@pytest.mark.parametrize("cf", [0.5, 1.25, 8.0])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_apply_matches_reference(arch, cf):
    cfg = _cfg(arch)
    jp, tp = _moe_params(cfg)
    x = _x(cfg, 2, 8)
    jy, jm = jmoe.moe_apply(jp, jnp.asarray(x), cfg, cf)
    ty, tm = moe.moe_apply(tp, torch.from_numpy(x), cfg, cf)
    _close(ty.numpy(), jy, RTOL, RTOL)
    for key in ("moe_aux", "moe_zloss"):
        _close(float(tm[key]), float(jm[key]), RTOL, 0.0)
    assert float(tm["moe_drop_frac"]) == float(jm["moe_drop_frac"])
    if cf == 0.5:
        assert float(tm["moe_drop_frac"]) > 0.0
    if cf == 8.0:
        assert float(tm["moe_drop_frac"]) == 0.0

    def j_apply(wd):
        return jmoe.moe_apply(dict(jp, w_down=wd), jnp.asarray(x), cfg, cf)[0]

    def t_apply(wd):
        return moe.moe_apply(dict(tp, w_down=wd), torch.from_numpy(x), cfg,
                             cf)[0]

    def t_grad(fn, wd):
        wd = wd.detach().requires_grad_(True)
        return torch.autograd.grad(fn(wd), wd)[0].numpy()
    want = _kept(j_apply, jp, x, "w_down", lambda f, wd: jax.grad(f)(wd))
    got = _kept(t_apply, tp, x, "w_down", t_grad)
    np.testing.assert_array_equal(got, want)
    if cf == 8.0:                   # nothing dropped: top_k per token
        assert (got.sum(-1) == cfg.moe.top_k).all()


def test_sort_is_stable_so_drops_keep_the_first_tokens():
    """With every token routed alike and capacity below the tokens' count,
    the kept ones are the first in token order (``jnp.argsort`` is
    stable; an unstable sort would keep others)."""
    cfg = _cfg("qwen3-moe-30b-a3b")
    _, tp = _moe_params(cfg)
    x = np.broadcast_to(_x(cfg, 1, 1), (1, 24, cfg.d_model)).copy()
    wd = tp["w_down"].detach().requires_grad_(True)
    y, m = moe.moe_apply(dict(tp, w_down=wd), torch.from_numpy(x), cfg,
                         capacity_factor=0.5)
    cap = int(0.5 * 24 * cfg.moe.top_k / cfg.moe.n_experts)
    reached = [bool(torch.autograd.grad(y[0, j].sum(), wd,
                                        retain_graph=True)[0].any())
               for j in range(24)]
    assert reached == [j < cap for j in range(24)]
    assert float(m["moe_drop_frac"]) == pytest.approx(1 - cap / 24)


# ---------------------------------------- the port's tests/test_moe.py
def _dense_mixture_ref(p, x, cfg):
    probs = torch.softmax(x @ p["router"], -1)
    gv, ei = torch.topk(probs, cfg.moe.top_k, dim=-1)
    gv = gv / gv.sum(-1, keepdim=True)
    ref = torch.zeros_like(x)
    for e in range(cfg.moe.n_experts):
        h = F.silu(x @ p["w_gate"][e]) * (x @ p["w_up"][e])
        w = ((ei == e) * gv).sum(-1)
        ref = ref + w[..., None] * (h @ p["w_down"][e])
    if "shared" in p:
        sh = p["shared"]
        ref = ref + (F.silu(x @ sh["w_gate"]) * (x @ sh["w_up"])) \
            @ sh["w_down"]
    return ref


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("bt", [(1, 4), (2, 8), (3, 17)])
def test_dispatch_matches_dense_mixture(arch, bt):
    cfg = _cfg(arch)
    _, p = _moe_params(cfg)
    x = torch.from_numpy(_x(cfg, *bt))
    y, m = moe.moe_apply(p, x, cfg, capacity_factor=8.0)  # no drops
    np.testing.assert_allclose(y.numpy(), _dense_mixture_ref(p, x, cfg),
                               rtol=1e-4, atol=1e-4)
    assert float(m["moe_drop_frac"]) == 0.0


def test_capacity_drops_are_bounded_and_reported():
    cfg = _cfg("deepseek-moe-16b")
    _, p = _moe_params(cfg)
    x = torch.from_numpy(_x(cfg, 2, 64, seed=2))
    y_tight, m_tight = moe.moe_apply(p, x, cfg, capacity_factor=0.5)
    _, m_loose = moe.moe_apply(p, x, cfg, capacity_factor=8.0)
    assert float(m_tight["moe_drop_frac"]) > 0.0
    assert float(m_loose["moe_drop_frac"]) == 0.0
    # dropped tokens only lose part of their mixture; outputs stay finite
    assert bool(torch.isfinite(y_tight).all())


def test_gates_are_differentiable():
    cfg = _cfg("qwen3-moe-30b-a3b")
    _, p = _moe_params(cfg, seed=3)
    x = torch.from_numpy(_x(cfg, 1, 8, seed=3))
    keys = [k for k, _ in tu.flatten_with_keys(p)]
    leaves = [v.requires_grad_(True) for v in tu.leaves(p)]
    live = tu.unflatten_like(p, dict(zip(keys, leaves)))
    y, m = moe.moe_apply(live, x, cfg)
    grads = dict(zip(keys, torch.autograd.grad(
        torch.sum(y ** 2) + m["moe_aux"], leaves)))
    gnorm = sum(float(g.abs().sum()) for g in grads.values())
    assert np.isfinite(gnorm) and gnorm > 0
    # router receives gradient (through gates AND the aux loss)
    assert float(grads["['router']"].abs().sum()) > 0


# -------------------------------------------------------------- model
def _runs(dtype, **kw):
    return (JRunConfig(remat="none", compute_dtype=getattr(jnp, dtype), **kw),
            RunConfig(remat="none", compute_dtype=getattr(torch, dtype), **kw))


@pytest.mark.parametrize("seq", [16, 21])
@pytest.mark.parametrize("dtype,rtol,floor", [
    ("float32", 1e-5, 1e-5),
    ("bfloat16", 2e-2, 2e-2),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch, dtype, rtol, floor, seq):
    cfg = _cfg(arch)
    jparams = j_init_tree(japi.param_specs(cfg), jax.random.key(0))
    batch = TokenStream(DataConfig(cfg.vocab_size, seq, 2, seed=0)).batch(0)
    jrun, run = _runs(dtype)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        japi.make_eval_loss(cfg, jrun)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tloss, tgrads = api.make_grad_fn(api.make_eval_loss(cfg, run))(
        _carried(jparams), batch)
    _close(float(tloss), float(jloss), rtol, 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads)}
    got = dict(tu.flatten_with_keys(tgrads))
    assert list(got) == list(want)
    assert "['layers']['moe']['router']" in got
    for key, g in want.items():
        _close(got[key].float().numpy(), g, rtol, floor)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One step of ``make_train_step`` (loss with the router's aux and
    z-loss terms, AdamW) from the same state and batch, in float32."""
    cfg = _cfg(arch)
    specs = japi.state_specs(cfg)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    state = convert.state_from_numpy(
        {k: np.asarray(v) for k, v in j_flatten(jstate)}, "cpu")
    batch = TokenStream(DataConfig(cfg.vocab_size, 16, 2, seed=1)).batch(0)
    jrun, run = _runs("float32", capacity_factor=1.0)
    jnew, jm = jax.jit(japi.make_train_step(cfg, jrun))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new, m = api.make_train_step(cfg, run)(state, batch)
    assert set(m) == set(jm) >= {"loss", "moe_aux", "moe_zloss",
                                 "moe_drop_frac", "grad_norm", "lr"}
    for key in jm:
        _close(float(m[key]), float(jm[key]), RTOL, 0.0)
    assert int(new.opt.step) == int(jnew.opt.step) == 1
    want = {k: np.asarray(v) for k, v in j_flatten(jnew.params)}
    got = dict(tu.flatten_with_keys(new.params))
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key].numpy(), w, 0.0, RTOL)


def test_convert_carries_the_moe_leaves_unchanged():
    """The routed and shared experts' leaves of a train state cross to the
    port and back bit for bit, under the reference's keys."""
    cfg = _cfg("deepseek-moe-16b")
    specs = japi.state_specs(cfg)
    rng = np.random.default_rng(4)
    flat = {k: rng.standard_normal(np.shape(v)).astype(np.asarray(v).dtype)
            if np.issubdtype(np.asarray(v).dtype, np.floating)
            else np.asarray(v)
            for k, v in j_flatten(japi.TrainState(
                j_init_tree(specs.params, jax.random.key(0)),
                j_init_tree(specs.opt, jax.random.key(0))))}
    state = convert.state_from_numpy(flat, "cpu")
    moe_p = state.params["layers"]["moe"]
    assert set(moe_p) == {"router", "w_gate", "w_up", "w_down", "shared"}
    assert moe_p["w_gate"].shape == (cfg.n_layers, cfg.moe.n_experts,
                                     cfg.d_model, cfg.moe.d_ff_expert)
    back = convert.state_to_numpy(state)
    assert list(back) == list(flat)
    for key in (".params['layers']['moe']['w_gate']",
                ".params['layers']['moe']['shared']['w_down']",
                ".opt.m['layers']['moe']['router']"):
        assert key in back
    for key, want in flat.items():
        assert back[key].dtype == want.dtype
        np.testing.assert_array_equal(back[key], want)
