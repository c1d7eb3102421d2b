"""Port parity for the encoder–decoder family (seamless-m4t-medium).

``reduced(seamless-m4t-medium)`` (2 + 2 layers, d_model 64, 4 / 2 heads
of 16, vocab 256) with JAX ``init_tree`` params carried across by
``repro_torch.convert``; the JAX functions run eagerly, as
``tests/test_arch_smoke.py`` runs them, and the train step under
``jax.jit``.  The port's prefill runs every attention through the
flash-attention kernel's plain version here (the encoder's and the
cross-attention non-causal, the decoder's causal); the JAX prefill runs
the ``blocked_attention`` twin.  Tolerances, as
``tests/test_torch_serving.py`` states them:

* float32 compute: 1e-5, relative, with a floor of 1e-5 of the largest
  value: the same arithmetic in another order;
* bfloat16 compute: 2e-2 of the largest value: the frameworks round bf16
  intermediates at different places;
* bf16 caches at float32 compute: one bf16 step (2**-7), since an element
  whose f32 values straddle a rounding boundary may land one step apart.
"""
from __future__ import annotations

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import reduced as j_reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import init_tree as j_init_tree
from repro.launch import serve as j_serve
from repro.models import api as japi
from repro.models import encdec as jencdec
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.configs.base import SHAPES, get_arch, reduced
from repro_torch.core import capsule
from repro_torch.distributed.sharding import init_tree
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch import serve
from repro_torch.models import api, encdec
from repro_torch.models.attention import KVCache
from repro_torch.models.lm import RunConfig

ARCH = "seamless-m4t-medium"
CFG = reduced(get_arch(ARCH))
JCFG = j_reduced(j_get_arch(ARCH))
TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2)}
CACHE_TOL = {"float32": 2.0 ** -7, "bfloat16": 2e-2}
MAX = 24


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy().astype(np.float64)
    return np.asarray(x, np.float64)


def _close(got, want, rtol, floor):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = floor * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


def _close_caches(got: dict, want: dict, tol):
    assert sorted(got) == sorted(want) == ["cross_kv", "self_kv"]
    for name in got:
        assert got[name].k.dtype == torch.bfloat16
        for g, w in zip(got[name], want[name], strict=True):
            _close(g, w, tol, tol)


@pytest.fixture(scope="module")
def params():
    jparams = j_init_tree(japi.param_specs(JCFG), jax.random.key(0))
    flat = {k: np.asarray(v) for k, v in j_flatten(jparams)}
    return jparams, convert.tree_from_numpy(flat, "cpu")


def _runs(dtype, remat="none"):
    return (JRunConfig(remat=remat, block_kv=8,
                       compute_dtype=getattr(jnp, dtype)),
            RunConfig(remat=remat, block_kv=8,
                      compute_dtype=getattr(torch, dtype)))


def _batch(b=2, t=12, s=None, seed=0):
    r = np.random.default_rng(seed)
    return {"tokens": r.integers(0, CFG.vocab_size, (b, t)).astype(np.int32),
            "labels": r.integers(0, CFG.vocab_size, (b, t)).astype(np.int32),
            "frames": r.standard_normal((b, s or t, CFG.d_model))
            .astype(np.float32)}


def _j(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


# ---------------------------------------------------------------- training
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_reference(params, dtype):
    jparams, tparams = params
    jrun, run = _runs(dtype)
    frames = _batch(s=20)["frames"]
    want = jencdec.encode(jparams, JCFG, jnp.asarray(frames), jrun)
    got = encdec.encode(tparams, CFG, torch.from_numpy(frames), run)
    _close(got, want, *TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_grads_match_reference(params, dtype):
    """The logits of ``forward_train`` (frames of 20 against 12 tokens),
    then the loss and every gradient through ``make_grad_fn``."""
    jparams, tparams = params
    jrun, run = _runs(dtype)
    batch = _batch(s=20)
    jlogits, _ = jencdec.forward_train(jparams, JCFG, jnp.asarray(
        batch["frames"]), jnp.asarray(batch["tokens"]), jrun)
    logits, metrics = encdec.forward_train(
        tparams, CFG, torch.from_numpy(batch["frames"]),
        torch.from_numpy(batch["tokens"]), run)
    assert metrics == {}
    _close(logits, jlogits, *TOL[dtype])

    jloss, jgrads = jax.value_and_grad(japi.make_eval_loss(JCFG, jrun))(
        jparams, _j(batch))
    loss, grads = api.make_grad_fn(api.make_eval_loss(CFG, run))(tparams,
                                                                 batch)
    _close(float(loss), float(jloss), TOL[dtype][0], 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jgrads)}
    got = dict(tu.flatten_with_keys(grads))
    assert list(got) == list(want)
    for key, g in want.items():
        _close(got[key], g, *TOL[dtype])


def test_remat_gives_the_same_grads(params):
    _, tparams = params
    batch = _batch(s=20)
    out = [api.make_grad_fn(api.make_eval_loss(CFG, _runs("float32", r)[1]))(
        tparams, batch) for r in ("none", "full")]
    assert float(out[0][0]) == float(out[1][0])
    for a, b in zip(tu.leaves(out[0][1]), tu.leaves(out[1][1]), strict=True):
        assert torch.equal(a, b)


def _states():
    specs = japi.state_specs(JCFG)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    return jstate, convert.state_from_numpy(
        {k: np.asarray(v) for k, v in j_flatten(jstate)}, "cpu")


def test_train_step_matches_reference():
    jstate, state = _states()
    batch = _batch(s=16, seed=1)
    jrun, run = _runs("float32")
    jnew, jm = jax.jit(japi.make_train_step(JCFG, jrun))(jstate, _j(batch))
    new, m = api.make_train_step(CFG, run)(state, batch)
    assert set(m) == set(jm) == {"loss", "grad_norm", "lr"}
    for key in jm:
        _close(float(m[key]), float(jm[key]), 1e-5, 0.0)
    want = {k: np.asarray(v) for k, v in j_flatten(jnew)}
    got = dict(tu.flatten_with_keys(new))
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key], w, 0.0, 1e-5)


def test_state_flattens_to_the_reference_keys():
    specs = japi.state_specs(JCFG)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(0)))
    tspecs = api.state_specs(CFG)
    gen = torch.Generator().manual_seed(0)
    state = api.TrainState(init_tree(tspecs.params, gen, device="cpu"),
                           init_tree(tspecs.opt, gen, device="cpu"))
    want = [(k, np.asarray(v).shape, str(np.asarray(v).dtype))
            for k, v in j_flatten(jstate)]
    got = [(k, tuple(v.shape), str(v.dtype).removeprefix("torch."))
           for k, v in tu.flatten_with_keys(state)]
    assert got == want
    assert any(".params['enc_layers']['attn']['wq']" in k for k, *_ in got)


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("reduce", [False, True])
def test_input_specs_equal_the_reference(shape, reduce):
    cfg, jcfg = get_arch(ARCH), j_get_arch(ARCH)
    if reduce:
        cfg, jcfg = CFG, JCFG
    got = api.input_specs(cfg, SHAPES[shape])
    want = japi.input_specs(jcfg, J_SHAPES[shape])
    assert list(got) == list(want)
    for key, w in want.items():
        g = got[key]
        assert (g.shape, g.axes, g.init) == (w.shape, w.axes, w.init), key
        assert str(g.dtype).removeprefix("torch.") == np.dtype(w.dtype).name
    dense = api.input_specs(get_arch("granite-3-2b"), SHAPES[shape])
    assert "frames" not in dense and list(dense) == list(
        japi.input_specs(j_get_arch("granite-3-2b"), J_SHAPES[shape]))


def test_capsule_boots_and_steps_on_the_cpu():
    """A seamless capsule's step: the same loss and new state as
    ``make_train_step`` with the capsule's AdamW settings, bit for bit (one
    arithmetic on one device), and the loss within 1e-5 of the JAX eval
    loss."""
    jstate, state = _states()
    run = RunConfig(remat="none", block_kv=8, compute_dtype=torch.float32)
    spec = capsule.CapsuleSpec(ARCH, "train_4k", run, arch_override=CFG)
    booted = capsule.boot(spec, "cpu", verify_hash=spec.manifest_hash)
    batch = _batch(s=16, seed=2)
    new, loss = booted.step(state, batch)
    want, m = api.make_train_step(CFG, run)(state, batch)
    assert float(loss) == float(m["loss"]) and int(new.opt.step) == 1
    for a, b in zip(tu.leaves(new), tu.leaves(want), strict=True):
        assert torch.equal(a, b)
    jloss = japi.make_eval_loss(JCFG, _runs("float32")[0])(jstate.params,
                                                           _j(batch))
    _close(float(loss), float(jloss), 1e-5, 0.0)


# ----------------------------------------------------------------- serving
def _torch_caches(jcaches: dict) -> dict:
    """The reference's bf16 caches as the port's tensors, bit for bit."""
    return {name: KVCache(*(torch.from_numpy(np.array(
        c.astype(jnp.float32))).to(torch.bfloat16) for c in kv))
        for name, kv in jcaches.items()}


@pytest.mark.parametrize("enc_len", [12, 20])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_matches_reference(params, dtype, enc_len, monkeypatch):
    """Prefill logits and both caches, frames as long as the prompt and
    longer (S 20 against T 12).  Prefill attends over its cross K/V
    rounded to bf16, so at float32 compute an element one bf16 step off
    (allowed in the caches) would move the logits by more than 1e-5 of
    their scale: the logits are held given the reference's rounded cross
    K/V, which the caches hold to one step."""
    jparams, tparams = params
    jrun, run = _runs(dtype)
    batch = _batch(s=enc_len)
    batch.pop("labels")
    jlogits, jcaches = japi.make_prefill_step(JCFG, MAX, jrun)(jparams,
                                                               _j(batch))
    logits, caches = api.make_prefill_step(CFG, MAX, run)(tparams, batch)
    assert caches["self_kv"].k.shape == (2, 2, MAX, 2, 16)
    assert caches["cross_kv"].k.shape == (2, 2, enc_len, 2, 16)
    _close_caches(caches, jcaches, CACHE_TOL[dtype])

    rounded = iter(zip(*_torch_caches(jcaches)["cross_kv"]))
    monkeypatch.setattr(encdec, "_cross_kv", lambda lp, enc_out: KVCache(
        *(c.to(enc_out.dtype) for c in next(rounded))))
    logits, _ = api.make_prefill_step(CFG, MAX, run)(tparams, batch)
    assert next(rounded, None) is None
    _close(logits, jlogits, *TOL[dtype])


@pytest.mark.parametrize("index", [12, (12, 7, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_matches_reference(params, dtype, index):
    """Two decode steps, each from the reference's caches (a prefill's,
    then its first step's): the logits, the self cache written at
    ``index`` (scalar, or one per sequence) and nowhere else, and the
    cross cache returned unchanged."""
    jparams, tparams = params
    jrun, run = _runs(dtype)
    batch = _batch(b=3, s=17, seed=3)
    batch.pop("labels")
    _, jcaches = japi.make_prefill_step(JCFG, MAX, jrun)(jparams, _j(batch))
    index = np.asarray(index, np.int32)
    tok = np.random.default_rng(3).integers(0, CFG.vocab_size,
                                            (3, 1)).astype(np.int32)
    for _ in range(2):
        caches = _torch_caches(jcaches)
        before = tu.tree_map(torch.clone, caches)
        jlogits, jcaches = japi.make_decode_step(JCFG, jrun)(
            jparams, jcaches, {"tokens": jnp.asarray(tok),
                               "index": jnp.asarray(index)})
        logits, new = api.make_decode_step(CFG, run)(
            tparams, caches, {"tokens": tok, "index": index})
        _close(logits, jlogits, *TOL[dtype])
        _close_caches(new, jcaches, CACHE_TOL[dtype])
        for got, was in zip(new["cross_kv"], before["cross_kv"],
                            strict=True):
            assert torch.equal(got, was)
        rows = torch.as_tensor(np.broadcast_to(index, (3,)).astype(np.int64))
        for got, was in zip(new["self_kv"], before["self_kv"], strict=True):
            changed = (got != was).any(-1).any(-1)          # (L, B, S)
            want = torch.zeros_like(changed)
            want[:, torch.arange(3), rows] = True
            assert torch.equal(changed, want)
        index = index + 1


def test_prefill_and_decode_match_teacher_forced(params):
    """The port's own prefill and decode against its ``forward_train`` over
    the same tokens, as ``tests/test_arch_smoke.py`` holds the reference's
    (5e-3: prefill reads its cross K/V rounded to bf16)."""
    _, tparams = params
    run = _runs("float32")[1]
    B, T = 2, 12
    r = np.random.default_rng(1)
    toks = r.integers(0, CFG.vocab_size, (B, T + 1)).astype(np.int32)
    frames = r.standard_normal((B, T, CFG.d_model)).astype(np.float32)
    full, _ = encdec.forward_train(tparams, CFG, torch.from_numpy(frames),
                                   torch.from_numpy(toks), run)
    last, caches = api.make_prefill_step(CFG, 20, run)(
        tparams, {"tokens": toks[:, :T], "frames": frames})
    np.testing.assert_allclose(_np(last), _np(full[:, T - 1]), rtol=5e-3,
                               atol=5e-3)
    dl, _ = api.make_decode_step(CFG, run)(
        tparams, caches, {"tokens": toks[:, T:T + 1], "index": T})
    np.testing.assert_allclose(_np(dl[:, 0]), _np(full[:, T]), rtol=5e-3,
                               atol=5e-3)


def test_prefill_attention_goes_through_the_kernel_wrapper(params,
                                                           monkeypatch):
    """Prefill: 3 x L calls of ``attend``, the encoder's L full, then per
    decoder layer its causal self-attention and its full cross-attention
    on the unrepeated K/V (T 12 against S 20); training: none."""
    _, tparams = params
    calls = []
    real = attn_ops.attend

    def counting(q, k, v, *, causal=True):
        calls.append((causal, q.shape[1], k.shape[1], k.shape[2]))
        return real(q, k, v, causal=causal)
    monkeypatch.setattr(attn_ops, "attend", counting)
    batch = _batch(s=20)
    run = _runs("float32")[1]
    api.make_eval_loss(CFG, run)(tparams, batch)
    api.make_grad_fn(api.make_eval_loss(CFG, run))(tparams, batch)
    assert calls == []
    batch.pop("labels")
    api.make_prefill_step(CFG, MAX, run)(tparams, batch)
    kv = CFG.n_kv_heads
    assert calls == [(False, 20, 20, kv)] * CFG.n_layers \
        + [(True, 12, 12, kv), (False, 12, 20, kv)] * CFG.n_layers


def test_kernel_refuses_inputs_that_require_grad():
    """The kernel has no backward: a call under autograd is a fault, on
    the plain route as on the card's; under ``no_grad`` it runs."""
    q, k, v = (torch.randn(1, 2, 5, 16, requires_grad=True)
               for _ in range(3))
    with pytest.raises(RuntimeError, match="no backward"):
        flash_attention(q, k, v, causal=False)
    with torch.no_grad():
        assert flash_attention(q, k, v, causal=False).shape == q.shape


def test_serve_launcher_hands_prefill_the_references_inputs(monkeypatch):
    """The port's serve launcher and the reference's draw the same prompts
    and frames: each prefill step receives them byte for byte (the
    reference's launcher run without ``jax.jit``, so its step sees
    arrays); the port's logits are finite and it decodes ``--gen``
    tokens."""
    argv = ["--arch", ARCH, "--requests", "2", "--prompt-len", "8",
            "--gen", "3", "--seed", "4"]
    seen = {}

    def capture(name, make):
        def factory(*a, **kw):
            step = make(*a, **kw)

            def prefill_step(params, batch):
                seen[name] = {k: np.asarray(v) for k, v in batch.items()}
                return step(params, batch)
            return prefill_step
        return factory
    monkeypatch.setattr(j_serve, "jax", types.SimpleNamespace(
        jit=lambda f: f, random=jax.random))
    monkeypatch.setattr(japi, "make_prefill_step",
                        capture("jax", japi.make_prefill_step))
    monkeypatch.setattr(api, "make_prefill_step",
                        capture("torch", api.make_prefill_step))
    j_serve.main(argv)
    before = flash_attention.launches
    out = serve.main(argv + ["--device", "cpu"])
    assert flash_attention.launches == before
    assert list(seen["torch"]) == list(seen["jax"]) == ["tokens", "frames"]
    for key, want in seen["jax"].items():
        got = seen["torch"][key]
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert seen["torch"]["frames"].shape == (2, 8, CFG.d_model)
    assert out["logits_finite"]
    assert np.asarray(out["tokens"]).shape == (2, 3)
