"""Port parity for the serving path: prefill, decode, engine, launcher.

``reduced(granite-3-2b)``, ``reduced(qwen2-1.5b)`` (qkv biases and tied
embeddings), ``reduced(deepseek-moe-16b)`` and
``reduced(qwen3-moe-30b-a3b)`` (MoE blocks: each batch row routed on its
own, so a prompt's experts and drops are the same in a batch as alone)
with JAX ``init_tree`` params carried across by ``repro_torch.convert``.
The port's prefill runs the flash-attention kernel's plain version here;
the JAX prefill runs the ``blocked_attention`` twin.  Tolerances, relative to the largest value compared:

* float32 compute: 1e-5.  Both sides do the same f32 arithmetic; the two
  attentions differ only in summation order (the twin's rounding of its
  probabilities to the compute dtype is a no-op in f32), and decode reads
  the same bf16 cache on both sides.
* bfloat16 compute: 2e-2.  The two frameworks round bf16 intermediates at
  different places, and the kernel keeps its probabilities in f32 where
  the JAX twin rounds them to bf16 before P·V.
* KV caches, bf16 on both sides: one bf16 step (2**-7 relative) at f32
  compute, since an element whose f32 values straddle a rounding boundary
  may land one step apart; the bf16 tolerance at bf16 compute.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_arch, reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import init_tree as j_init_tree
from repro.models import api as japi
from repro.models.lm import RunConfig as JRunConfig
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JServingEngine
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.launch import serve
from repro_torch.models import api, attention
from repro_torch.models.lm import RunConfig
from repro_torch.serving.engine import Request, ServingEngine

ARCHS = ["granite-3-2b", "qwen2-1.5b", "deepseek-moe-16b",
         "qwen3-moe-30b-a3b"]
TOL = {"float32": 1e-5, "bfloat16": 2e-2}
CACHE_TOL = {"float32": 2.0 ** -7, "bfloat16": 2e-2}
MAX = 48


def _cfg(arch):
    return reduced(get_arch(arch))


def _params(cfg, seed=0):
    jparams = j_init_tree(japi.param_specs(cfg), jax.random.key(seed))
    flat = {k: np.asarray(v) for k, v in j_flatten(jparams)}
    return jparams, convert.tree_from_numpy(flat, "cpu")


def _runs(dtype):
    return (JRunConfig(remat="none", block_kv=16,
                       compute_dtype=getattr(jnp, dtype)),
            RunConfig(remat="none", block_kv=16,
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


def _close_caches(got: dict, want: dict, tol):
    assert got["kv"].k.dtype == torch.bfloat16
    for g, w in zip(got["kv"], want["kv"]):
        _close(g, w, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill logits and caches, then three decode steps fed the JAX
    side's greedy tokens (teacher forcing), with a scalar index."""
    cfg = _cfg(arch)
    jparams, params = _params(cfg)
    jrun, run = _runs(dtype)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab_size, (2, 13)).astype(np.int32)

    jlogits, jcaches = japi.make_prefill_step(cfg, MAX, jrun)(
        jparams, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_step(cfg, MAX, run)(
        params, {"tokens": prompts})
    _close(logits, jlogits, TOL[dtype])
    _close_caches(caches, jcaches, CACHE_TOL[dtype])

    jdecode = japi.make_decode_step(cfg, jrun)
    decode = api.make_decode_step(cfg, run)
    tok = np.array(jnp.argmax(jlogits[:, :cfg.vocab_size], -1),
                   np.int32)[:, None]
    for i in range(3):
        index = prompts.shape[1] + i
        jlogits, jcaches = jdecode(jparams, jcaches,
                                   {"tokens": jnp.asarray(tok),
                                    "index": jnp.int32(index)})
        logits, caches = decode(params, caches,
                                {"tokens": tok, "index": index})
        _close(logits, jlogits, TOL[dtype])
        _close_caches(caches, jcaches, CACHE_TOL[dtype])
        tok = np.array(jnp.argmax(jlogits[:, 0, :cfg.vocab_size], -1),
                       np.int32)[:, None]


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_with_a_per_sequence_index_matches_reference(arch):
    """A (B,) index: each sequence writes and attends at its own length."""
    cfg = _cfg(arch)
    jparams, params = _params(cfg, seed=1)
    jrun, run = _runs("float32")
    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 11)).astype(np.int32)
    jlogits, jcaches = japi.make_prefill_step(cfg, MAX, jrun)(
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
        _close_caches(caches, jcaches, CACHE_TOL["float32"])
        index = index + 1


def test_prefill_attention_goes_through_the_kernel_wrapper(monkeypatch):
    cfg = _cfg("granite-3-2b")
    _, params = _params(cfg)
    calls = []
    real = attention.attn_ops.attend

    def counting(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)
    monkeypatch.setattr(attention.attn_ops, "attend", counting)
    api.make_prefill_step(cfg, MAX, _runs("float32")[1])(
        params, {"tokens": np.zeros((2, 5), np.int32)})
    assert len(calls) == cfg.n_layers


def test_windowed_prefill_stays_on_the_twin_and_matches_reference(
        monkeypatch):
    """The kernel has no sliding window (nor has the TPU kernel): a
    windowed config computes prefill with ``blocked_attention``; decode
    masks all but the last ``window`` positions."""
    cfg = dataclasses.replace(_cfg("granite-3-2b"), window=4)
    jparams, params = _params(cfg)
    jrun, run = _runs("float32")
    monkeypatch.setattr(attention.attn_ops, "attend", None)  # never called
    prompts = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 10)).astype(np.int32)
    jlogits, jcaches = japi.make_prefill_step(cfg, MAX, jrun)(
        jparams, {"tokens": jnp.asarray(prompts)})
    logits, caches = api.make_prefill_step(cfg, MAX, run)(
        params, {"tokens": prompts})
    _close(logits, jlogits, TOL["float32"])
    _close_caches(caches, jcaches, CACHE_TOL["float32"])
    tok = np.asarray([[3], [5]], np.int32)
    jlogits, _ = japi.make_decode_step(cfg, jrun)(
        jparams, jcaches, {"tokens": jnp.asarray(tok),
                           "index": jnp.int32(10)})
    logits, _ = api.make_decode_step(cfg, run)(
        params, caches, {"tokens": tok, "index": 10})
    _close(logits, jlogits, TOL["float32"])


# ---------------------------------------------------------------- engine
def _single_reference(cfg, params, run, prompt, n_new, max_len):
    """Slot-free greedy generation for one request."""
    prefill = api.make_prefill_step(cfg, max_len, run)
    decode = api.make_decode_step(cfg, run)
    logits, caches = prefill(params, {"tokens": prompt[None, :]})
    out = [int(torch.argmax(logits[0, :cfg.vocab_size]))]
    pos = len(prompt)
    for _ in range(n_new - 1):
        lg, caches = decode(params, caches,
                            {"tokens": np.asarray([[out[-1]]], np.int32),
                             "index": pos})
        out.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
        pos += 1
    return out


@pytest.mark.parametrize("arch", ARCHS + ["falcon-mamba-7b", "hymba-1.5b"])
def test_engine_matches_isolated_generation(arch):
    """The port's copy of ``tests/test_serving.py``'s test, plus the JAX
    engine's tokens on the same params and queue: greedy tokens at f32
    compute, where the logits agree to 1e-5 (above; 1e-4 for the SSM and
    hybrid families, ``tests/test_torch_ssm_serving.py``).  The pool cache
    carries ``{"ssm": SSMCache}`` and, for the hybrid, ``{"kv", "ssm"}``."""
    cfg = _cfg(arch)
    jparams, params = _params(cfg)
    run = _runs("float32")[1]
    rng = np.random.default_rng(0)
    MAXLEN = 64
    reqs, refs = [], []
    for i, (plen, gen) in enumerate([(8, 6), (12, 4), (5, 8), (9, 5), (7, 3)]):
        prompt = rng.integers(0, cfg.vocab_size, plen).astype(np.int32)
        reqs.append(Request(i, prompt, gen))
        refs.append(_single_reference(cfg, params, run, prompt, gen, MAXLEN))

    jengine = JServingEngine(cfg, jparams, slots=2, max_len=MAXLEN,
                             run=_runs("float32")[0])
    jdone = {r.request_id: r.output for r in jengine.run_queue(
        [JRequest(r.request_id, r.prompt, r.max_new_tokens) for r in reqs])}
    engine = ServingEngine(cfg, params, slots=2, max_len=MAXLEN, run=run)
    done = engine.run_queue(reqs)
    assert len(done) == 5
    assert engine.stats["served"] == 5
    assert engine.stats["prefills"] == 5
    by_id = {r.request_id: r for r in done}
    for i, ref in enumerate(refs):
        assert by_id[i].output == ref, (i, by_id[i].output, ref)
        assert by_id[i].output == jdone[i], (i, by_id[i].output, jdone[i])
    # continuous batching actually shared decode steps across slots
    total_tokens = sum(len(r.output) for r in done)
    assert engine.stats["decode_steps"] < total_tokens


def test_engine_latency_accounting():
    cfg = _cfg("granite-3-2b")
    _, params = _params(cfg, seed=1)
    rng = np.random.default_rng(1)
    req = Request(0, rng.integers(0, cfg.vocab_size, 6).astype(np.int32), 3)
    engine = ServingEngine(cfg, params, slots=1, max_len=32,
                           run=_runs("float32")[1])
    done = engine.run_queue([req])[0]
    assert done.first_token_s is not None and done.done_s >= done.first_token_s
    assert len(done.output) == 3


def test_engine_holds_one_compute_dtype_copy_of_the_params():
    cfg = _cfg("granite-3-2b")
    _, params = _params(cfg)
    engine = ServingEngine(cfg, params, slots=1, max_len=16,
                           run=RunConfig(compute_dtype=torch.bfloat16))
    dtypes = {p.dtype for p in tu.leaves(engine.params)}
    assert dtypes == {torch.bfloat16}


# -------------------------------------------------------------- launcher
def test_serve_launcher_runs_on_the_cpu():
    before = flash_attention.launches
    out = serve.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                      "--requests", "2", "--prompt-len", "8", "--gen", "4"])
    assert out["device"] == "cpu" and out["requests"] == 2
    assert out["logits_finite"]
    assert np.asarray(out["tokens"]).shape == (2, 4)
    assert out["decode_tokens_per_s"] > 0 and out["prefill_s"] > 0
    # the CUDA route was not taken
    assert flash_attention.launches == before


def test_serve_launcher_samples_at_a_temperature():
    """``--temperature 0.8`` draws from a ``torch.Generator`` seeded with
    ``--seed``: finite logits, every token inside the vocabulary, the same
    tokens for one seed twice and other tokens for another seed."""
    def sample(seed):
        return serve.main(["--device", "cpu", "--arch", "qwen2-1.5b",
                           "--requests", "3", "--prompt-len", "8", "--gen",
                           "12", "--temperature", "0.8", "--seed",
                           str(seed)])
    out = sample(3)
    vocab = serve.reduced(serve.get_arch("qwen2-1.5b")).vocab_size
    tokens = np.asarray(out["tokens"])
    assert out["logits_finite"] and tokens.shape == (3, 12)
    assert tokens.min() >= 0 and tokens.max() < vocab
    assert sample(3)["tokens"] == out["tokens"]
    assert sample(4)["tokens"] != out["tokens"]


def test_serve_launcher_refuses_to_fall_back_to_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--requests", "1", "--prompt-len", "4", "--gen", "2"])
