"""Port parity for AdamW: three ``update`` steps against the reference.

Same params, same numpy gradients, same config.  Tolerance 1e-6 relative
(floor 1e-7 of the largest value): the scalar terms (bias corrections,
schedule, clip scale) are float32 tensors on both sides, so the two differ
only where XLA fuses or reorders float32 arithmetic (e.g. a contracted
multiply-add, the order of the global-norm sum).
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.snapshots import _flatten as j_flatten
from repro.optim import adamw as jadamw
from repro_torch import tree as tu
from repro_torch.optim import adamw


def _params(rng) -> dict:
    return {"embed": rng.standard_normal((40, 16)).astype(np.float32),
            "layers": {"w": rng.standard_normal((2, 16, 24))
                       .astype(np.float32),
                       "ln": np.ones((2, 16), np.float32)},
            "final_norm": rng.standard_normal(16).astype(np.float32)}


def _close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-6,
                               atol=1e-7 * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("clip_norm", [1.0, 1e3])   # clipped / not clipped
def test_three_steps_match_reference(clip_norm):
    rng = np.random.default_rng(0)
    p0 = _params(rng)
    cfg_kw = dict(lr=3e-3, warmup_steps=2, total_steps=5, clip_norm=clip_norm)
    jcfg, tcfg = jadamw.AdamWConfig(**cfg_kw), adamw.AdamWConfig(**cfg_kw)
    jp = {k: v for k, v in p0.items()}
    jp = _jax(jp)
    tp = tu.tree_map(torch.from_numpy, p0)
    zeros = lambda t: tu.tree_map(torch.zeros_like, t)  # noqa: E731
    jst = jadamw.AdamWState(jnp.zeros((), jnp.int32),
                            _jax(_zeros_np(p0)), _jax(_zeros_np(p0)))
    tst = adamw.AdamWState(torch.zeros((), dtype=torch.int32), zeros(tp),
                           zeros(tp))
    for step in range(3):
        g = tu.tree_map(lambda a: (rng.standard_normal(a.shape) * 3)
                        .astype(np.float32), p0)
        jp, jst, jm = jadamw.update(jcfg, _jax(g), jst, jp)
        tp, tst, tm = adamw.update(tcfg, tu.tree_map(torch.from_numpy, g),
                                   tst, tp)
        assert int(tst.step) == int(jst.step) == step + 1
        _close(float(tm["lr"]), float(jm["lr"]))
        _close(float(tm["grad_norm"]), float(jm["grad_norm"]))
        for (key, want), (tkey, got) in zip(
                j_flatten((jp, jst.m, jst.v)),
                tu.flatten_with_keys((tp, tst.m, tst.v))):
            assert key == tkey
            _close(got.numpy(), np.asarray(want))


def test_update_is_functional():
    """``update`` returns new tensors and leaves its inputs untouched."""
    rng = np.random.default_rng(1)
    p = tu.tree_map(torch.from_numpy, _params(rng))
    st = adamw.AdamWState(torch.zeros((), dtype=torch.int32),
                          tu.tree_map(torch.zeros_like, p),
                          tu.tree_map(torch.zeros_like, p))
    before = [t.clone() for t in tu.leaves((p, st))]
    versions = [t._version for t in tu.leaves((p, st))]
    grads = tu.tree_map(torch.ones_like, p)
    new_p, new_st, _ = adamw.update(adamw.AdamWConfig(), grads, st, p)
    for t, b, v in zip(tu.leaves((p, st)), before, versions):
        assert torch.equal(t, b) and t._version == v
    assert all(a is not b for a, b in zip(tu.leaves(new_p), tu.leaves(p)))


def _zeros_np(tree):
    return tu.tree_map(np.zeros_like, tree)


def _jax(tree):
    return tu.tree_map(jnp.asarray, tree)
