"""Port parity for the SSM and hybrid families on the serving path.

``reduced(falcon-mamba-7b)`` (attention-free Mamba1 blocks) and
``reduced(hymba-1.5b)`` (parallel attention and Mamba heads mixed as
0.5 (norm(attn) + norm(ssm)), then the MLP) with JAX ``init_tree``
params carried across by ``repro_torch.convert``.  The port's prefill runs
the scan kernel's plain version (a sequential loop) and the attention
kernel's; the JAX prefill runs the chunked associative scan and the
``blocked_attention`` twin.  Tolerances, relative to the largest value
compared:

* float32 compute: 1e-4, for the sequential against the associative
  summation order of the scan;
* bfloat16 compute: 2e-2: the two frameworks round bf16 intermediates at
  different places.  The conv cache holds bf16-rounded inputs in f32.
* KV caches, bf16 on both sides: one bf16 step (2**-7) at f32 compute.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.models import lm as jlm
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch.kernels.ssm_scan.kernel import ssm_scan
from repro_torch.launch import serve
from repro_torch.models import api, attention, lm, ssm
from repro_torch.models.lm import RunConfig

ARCHS = ["falcon-mamba-7b", "hymba-1.5b"]
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
KV_TOL = {"float32": 2.0 ** -7, "bfloat16": 2e-2}
MAX = 40


def _cfg(arch):
    return reduced(get_arch(arch))


def _params(cfg, seed=0):
    jparams = j_init_tree(japi.param_specs(cfg), jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in j_flatten(jparams)}
    return jparams, convert.tree_from_numpy(flat, "cpu")


def _runs(dtype, chunk=8):
    return (JRunConfig(remat="none", block_kv=16, ssm_chunk=chunk,
                       compute_dtype=getattr(jnp, dtype)),
            RunConfig(remat="none", block_kv=16, ssm_chunk=chunk,
                      compute_dtype=getattr(torch, dtype)))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _close_caches(got: dict, want: dict, dtype):
    assert set(got) == set(want)
    if "kv" in got:
        assert got["kv"].k.dtype == torch.bfloat16
        for g, w in zip(got["kv"], want["kv"]):
            _close(g, w, KV_TOL[dtype])
    assert got["ssm"].conv.dtype == got["ssm"].h.dtype == torch.float32
    for g, w in zip(got["ssm"], want["ssm"]):
        _close(g, w, TOL[dtype])


@pytest.mark.parametrize("plen", [13, 2])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype, plen):
    """Prefill logits and caches, then three decode steps fed the JAX
    side's greedy tokens.  A 2-token prompt is shorter than d_conv - 1, so
    the conv tail is left-padded with zeros."""
    cfg = _cfg(arch)
    jparams, params = _params(cfg)
    jrun, run = _runs(dtype)
    prompts = np.random.default_rng(plen).integers(
        0, cfg.vocab_size, (2, plen)).astype(np.int32)

    jlogits, jcaches = japi.make_prefill_step(cfg, MAX, jrun)(
        jparams, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_step(cfg, MAX, run)(
        params, {"tokens": prompts})
    _close(logits, jlogits, TOL[dtype])
    _close_caches(caches, jcaches, dtype)
    if plen == 2:
        assert not caches["ssm"].conv[:, :, 0].any()

    jdecode = japi.make_decode_step(cfg, jrun)
    decode = api.make_decode_step(cfg, run)
    tok = np.array(jnp.argmax(jlogits[:, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for i in range(3):
        index = plen + i
        jlogits, jcaches = jdecode(jparams, jcaches,
                                   {"tokens": jnp.asarray(tok),
                                    "index": jnp.int32(index)})
        logits, caches = decode(params, caches,
                                {"tokens": tok, "index": index})
        _close(logits, jlogits, TOL[dtype])
        _close_caches(caches, jcaches, dtype)
        tok = np.array(jnp.argmax(jlogits[:, 0, :cfg.vocab_size], -1),
                       np.int32)[:, None]


def test_hybrid_decode_with_a_per_sequence_index_matches_reference():
    cfg = _cfg("hymba-1.5b")
    jparams, params = _params(cfg, seed=1)
    jrun, run = _runs("float32")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    _, jcaches = japi.make_prefill_step(cfg, MAX, jrun)(
        jparams, {"tokens": jnp.asarray(prompts)})
    _, caches = api.make_prefill_step(cfg, MAX, run)(params,
                                                     {"tokens": prompts})
    index = np.asarray([11, 7, 9], np.int32)
    tok = rng.integers(0, cfg.vocab_size, (3, 1)).astype(np.int32)
    for _ in range(2):
        jlogits, jcaches = japi.make_decode_step(cfg, jrun)(
            jparams, jcaches, {"tokens": jnp.asarray(tok),
                               "index": jnp.asarray(index)})
        logits, caches = api.make_decode_step(cfg, run)(
            params, caches, {"tokens": tok, "index": index})
        _close(logits, jlogits, TOL["float32"])
        _close_caches(caches, jcaches, "float32")
        index = index + 1


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_reference(arch, dtype):
    """The full forward (the chunked twin ``chip_smoke.py`` checks the
    kernel's path against), with a ragged last chunk."""
    cfg = _cfg(arch)
    jparams, params = _params(cfg, seed=2)
    jrun, run = _runs(dtype, chunk=8)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 21)).astype(np.int32)
    want, _ = jlm.forward_train(jparams, cfg, jnp.asarray(tokens), jrun)
    got, _ = lm.forward_train(params, cfg, torch.from_numpy(tokens), run)
    _close(got, want, TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_goes_through_the_kernel_wrappers(arch, monkeypatch):
    cfg = _cfg(arch)
    _, params = _params(cfg)
    calls = {"scan": 0, "attend": 0}

    def counting(name, real):
        def fn(*a, **kw):
            calls[name] += 1
            return real(*a, **kw)
        return fn
    monkeypatch.setattr(ssm.ssm_ops, "selective_scan",
                        counting("scan", ssm.ssm_ops.selective_scan))
    monkeypatch.setattr(attention.attn_ops, "attend",
                        counting("attend", attention.attn_ops.attend))
    api.make_prefill_step(cfg, MAX, _runs("float32")[1])(
        params, {"tokens": np.zeros((2, 5), np.int32)})
    assert calls["scan"] == cfg.n_layers
    assert calls["attend"] == (cfg.n_layers if cfg.family == "hybrid"
                               else 0)


def test_convert_carries_the_ssm_params_unchanged():
    """``A_log``, ``D``, ``dt_bias`` and ``conv_b`` (the leaves that are
    not plain matrices, with non-default values) cross bit for bit."""
    cfg = _cfg("hymba-1.5b")
    jparams, _ = _params(cfg)
    rng = np.random.default_rng(3)
    flat = {}
    for k, v in j_flatten(jparams):
        v = np.asarray(v)
        if any(f"['{name}']" in k for name in ("A_log", "D", "dt_bias",
                                               "conv_b")):
            v = rng.standard_normal(v.shape).astype(v.dtype)
        flat[k] = v
    tree = convert.tree_from_numpy(flat, "cpu")
    got = tree["layers"]["ssm"]
    for name in ("A_log", "D", "dt_bias", "conv_b"):
        want = flat[f"['layers']['ssm']['{name}']"]
        assert got[name].dtype == torch.float32
        np.testing.assert_array_equal(got[name].numpy(), want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_runs_on_the_cpu(arch):
    before = ssm_scan.launches
    out = serve.main(["--device", "cpu", "--arch", arch, "--requests", "2",
                      "--prompt-len", "6", "--gen", "4"])
    assert out["device"] == "cpu" and out["logits_finite"]
    assert np.asarray(out["tokens"]).shape == (2, 4)
    assert ssm_scan.launches == before      # the CUDA route was not taken


def test_serve_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "falcon-mamba-7b", "--requests", "1",
                    "--prompt-len", "4", "--gen", "2"])
