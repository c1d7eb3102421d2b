"""The port's launch tooling against the reference's: ``launch/cell.py``
(``build_cell``, ``concrete_batch``), ``launch/flop_analysis.py`` (the
counterpart of ``launch/hlo_analysis.py``), ``launch/dryrun.py``,
``launch/mesh.py``, ``RunConfig.remat_policy`` and the sharding module's
``abstract_tree`` and ``param_bytes``.

Tolerances are ``tests/test_torch_model.py``'s and
``tests/test_torch_serving.py``'s: float32 compute, 1e-5 of the largest
value compared (both sides do the same f32 arithmetic in another order);
a bf16 KV cache one bf16 step (2**-7).

``traced_flops`` counts what eager PyTorch runs; the reference's
``stablehlo_flops`` parses the lowered StableHLO.  At ``remat="none"``
they agree exactly.  Under either remat policy the reference's parser
misses one call edge: JAX prints the call from the checkpointed layer
into ``blocked_attention``'s key-block loop as ``call @closed_call_…``,
without the ``func.`` prefix that ``hlo_analysis._CALL_RE`` matches, so
that loop's two products (Q·Kᵀ and P·V, ``dot_general``) go uncounted,
2-4 % of the step here.  The test holds the two within 5 %, and exactly
once that call is spelled as the parser expects.
"""
from __future__ import annotations

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import SHAPES as J_SHAPES
from repro.configs.base import get_arch as j_get_arch
from repro.configs.base import list_archs
from repro.configs.base import reduced as j_reduced
from repro.core.snapshots import _flatten as j_flatten
from repro.distributed.sharding import abstract_tree as j_abstract_tree
from repro.distributed.sharding import init_tree as j_init_tree
from repro.distributed.sharding import param_bytes as j_param_bytes
from repro.launch import cell as j_cell
from repro.launch.hlo_analysis import stablehlo_flops
from repro.models import api as japi
from repro.models.lm import RunConfig as JRunConfig
from repro_torch import convert
from repro_torch import tree as tu
from repro_torch.configs.base import SHAPES, get_arch, reduced
from repro_torch.distributed.sharding import abstract_tree, param_bytes
from repro_torch.kernels.flash_attention import kernel as fa
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssm_scan import kernel as ss
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
from repro_torch.launch import cell, dryrun, flop_analysis, mesh
from repro_torch.models import api
from repro_torch.models.lm import RunConfig

TOL = 1e-5
CACHE_TOL = 2.0 ** -7


def _close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    atol = tol * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol)


def _small(shape_name: str, seq_len: int = 16, batch: int = 2):
    return (dataclasses.replace(J_SHAPES[shape_name], seq_len=seq_len,
                                global_batch=batch),
            dataclasses.replace(SHAPES[shape_name], seq_len=seq_len,
                                global_batch=batch))


def _flat(tree) -> dict:
    return {k: np.asarray(v) for k, v in j_flatten(tree)}


# ------------------------------------------------------ sharding, mesh
@pytest.mark.parametrize("arch", list_archs())
def test_param_bytes_equal_the_reference(arch):
    jcfg, cfg = j_get_arch(arch), get_arch(arch)
    assert param_bytes(api.param_specs(cfg)) == \
        j_param_bytes(japi.param_specs(jcfg))
    assert param_bytes(api.state_specs(cfg)) == \
        j_param_bytes(japi.state_specs(jcfg))


def test_abstract_tree_is_the_specs_on_meta():
    specs = api.state_specs(get_arch("granite-3-2b"))
    tree = abstract_tree(specs)
    jtree = j_abstract_tree(japi.state_specs(j_get_arch("granite-3-2b")))
    got = tu.flatten_with_keys(tree)
    assert [k for k, _ in got] == [k for k, _ in j_flatten(jtree)]
    for (_, t), (_, s) in zip(got, tu.flatten_with_keys(specs)):
        assert t.device.type == "meta" and tuple(t.shape) == s.shape
        assert t.dtype == s.dtype


def test_device_by_name():
    assert mesh.device_by_name("host") == torch.device("cpu")
    assert mesh.device_by_name("meta") == torch.device("meta")
    with pytest.raises(ValueError):
        mesh.device_by_name("multi_pod")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            mesh.device_by_name("card")


# ----------------------------------------------------------------- cell
@pytest.mark.parametrize("arch,shape_name", [
    ("granite-3-2b", "train_4k"), ("granite-3-2b", "prefill_32k"),
    ("granite-3-2b", "decode_32k"), ("seamless-m4t-medium", "train_4k")])
def test_concrete_batch_is_the_references(arch, shape_name):
    jshape, shape = _small(shape_name, seq_len=12, batch=3)
    want = j_cell.concrete_batch(j_reduced(j_get_arch(arch)), jshape, 5)
    got = cell.concrete_batch(reduced(get_arch(arch)), shape, 5)
    assert list(got) == list(want)
    for key in want:
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key])


def _host_mesh():
    """``repro.launch.mesh.make_host_mesh``'s (1, 1) mesh with its axes
    typed ``Auto``: the installed JAX makes ``jax.make_mesh``'s axes
    ``Explicit`` by default, and the reference's ``constrain`` then
    refuses its ``with_sharding_constraint`` (its own tests build no
    cell)."""
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(jax.sharding.AxisType.Auto,) * 2)


def _runs():
    return (JRunConfig(remat="none", block_kv=8, compute_dtype=jnp.float32),
            RunConfig(remat="none", block_kv=8, compute_dtype=torch.float32))


def test_build_cell_on_the_cpu_matches_the_reference():
    """Train (loss, metrics and the updated state), then prefill (logits and
    cache), then decode from the reference's prefill cache (logits), each
    the reference's ``build_cell`` on a host mesh against the port's at
    ``device="cpu"``, from the reference's state carried across."""
    jcfg, cfg = j_reduced(j_get_arch("granite-3-2b")), \
        reduced(get_arch("granite-3-2b"))
    jrun, run = _runs()
    host = _host_mesh()

    jshape, shape = _small("train_4k")
    jc = j_cell.build_cell(jcfg, jshape, host, jrun)
    c = cell.build_cell(cfg, shape, "cpu", run)
    assert c.kind == jc.kind == "train" and c.donated == (0,)
    specs = japi.state_specs(jcfg)
    jstate = japi.TrainState(j_init_tree(specs.params, jax.random.key(0)),
                             j_init_tree(specs.opt, jax.random.key(1)))
    state = convert.state_from_numpy(_flat(jstate), "cpu")
    batch = j_cell.concrete_batch(jcfg, jshape)
    assert all(np.array_equal(c.args[1][k].numpy(), v)
               for k, v in batch.items())
    new, metrics = c.step(state, c.args[1])
    jnew, jmetrics = jc.step(jstate, batch)
    for key in jmetrics:
        _close(float(metrics[key]), float(jmetrics[key]), TOL)
    want = _flat(jnew)
    got = dict(tu.flatten_with_keys(new))
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key], w, TOL)

    # the train step took the reference's state over (donated)
    jparams = j_init_tree(specs.params, jax.random.key(0))
    jshape, shape = _small("prefill_32k")
    jc = j_cell.build_cell(jcfg, jshape, host, jrun)
    c = cell.build_cell(cfg, shape, "cpu", run)
    batch = j_cell.concrete_batch(jcfg, jshape)
    jlogits, jcache = jc.step(jparams, batch)
    logits, cache = c.step(state.params, c.args[1])
    _close(logits, jlogits, TOL)
    for g, w in zip(tu.leaves(cache), jax.tree.leaves(jcache)):
        _close(g, w, CACHE_TOL)

    jshape, shape = _small("decode_32k")
    jc = j_cell.build_cell(jcfg, jshape, host, jrun)
    c = cell.build_cell(cfg, shape, "cpu", run)
    assert c.donated == (1,)
    assert all(float(x.abs().max()) == 0 for x in tu.leaves(c.args[1]))
    batch = j_cell.concrete_batch(jcfg, jshape)
    cache = convert.tree_from_numpy(_flat(jcache), "cpu")
    cache = {"kv": type(c.args[1]["kv"])(cache["kv"]["k"],
                                         cache["kv"]["v"])}
    logits, _ = c.step(state.params, cache, c.args[2])
    jlogits, _ = jc.step(jparams, jcache, batch)
    _close(logits, jlogits, TOL)


def test_build_cell_refuses_what_the_reference_refuses():
    with pytest.raises(ValueError, match="long_500k skipped"):
        cell.build_cell(reduced(get_arch("granite-3-2b")),
                        SHAPES["long_500k"], "meta")


# --------------------------------------------------------------- remat
@pytest.mark.parametrize("arch,remat", [
    ("granite-3-2b", "none"), ("granite-3-2b", "full"),
    ("granite-3-2b", "dots"), ("seamless-m4t-medium", "dots")])
def test_remat_losses_and_grads_match_the_reference(arch, remat):
    jcfg, cfg = j_reduced(j_get_arch(arch)), reduced(get_arch(arch))
    jshape, _ = _small("train_4k")
    jparams = j_init_tree(japi.param_specs(jcfg), jax.random.key(0))
    batch = j_cell.concrete_batch(jcfg, jshape, 1)
    jrun = JRunConfig(remat=remat, block_kv=8, compute_dtype=jnp.float32)
    run = RunConfig(remat=remat, block_kv=8, compute_dtype=torch.float32)
    jloss, jgrads = jax.jit(jax.value_and_grad(
        japi.make_eval_loss(jcfg, jrun)))(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, grads = api.make_grad_fn(api.make_eval_loss(cfg, run))(
        convert.tree_from_numpy(_flat(jparams), "cpu"), batch)
    _close(float(loss), float(jloss), TOL)
    want = _flat(jgrads)
    got = dict(tu.flatten_with_keys(grads))
    assert list(got) == list(want)
    for key, w in want.items():
        _close(got[key], w, TOL)


def test_remat_policy():
    assert RunConfig(remat="none").remat_policy() is None
    full = RunConfig(remat="full").remat_policy()
    assert full is torch.utils.checkpoint.noop_context_fn
    # "dots": a forward and a recompute context, which keep the products
    assert len(RunConfig(remat="dots").remat_policy()()) == 2


# -------------------------------------------------------- flop analysis
def _reference_flops(jcfg, jshape, jrun) -> tuple:
    text = jax.jit(japi.make_train_step(jcfg, jrun)).lower(
        j_abstract_tree(japi.state_specs(jcfg)),
        j_abstract_tree(japi.input_specs(jcfg, jshape))).as_text()
    respelled = text.replace(" call @", " func.call @") \
        .replace("func.func.call @", "func.call @")
    return stablehlo_flops(text), stablehlo_flops(respelled)


@pytest.mark.parametrize("remat", ["none", "full", "dots"])
def test_traced_flops_match_the_reference(remat):
    jcfg, cfg = j_reduced(j_get_arch("granite-3-2b")), \
        reduced(get_arch("granite-3-2b"))
    jshape, shape = _small("train_4k", seq_len=32)
    jrun = JRunConfig(remat=remat, block_kv=16, compute_dtype=jnp.float32)
    run = RunConfig(remat=remat, block_kv=16, compute_dtype=torch.float32)
    want, want_respelled = _reference_flops(jcfg, jshape, jrun)
    c = cell.build_cell(cfg, shape, "meta", run)
    got = flop_analysis.traced_flops(c.step, *c.args)
    assert got == want_respelled
    if remat == "none":
        assert got == want
    else:
        assert 1.0 < got / want < 1.05


def test_dots_trace_fewer_flops_than_full():
    cfg = reduced(get_arch("granite-3-2b"))
    _, shape = _small("train_4k", seq_len=32)
    flops = {}
    for remat in ("none", "full", "dots"):
        c = cell.build_cell(cfg, shape, "meta", RunConfig(remat=remat))
        flops[remat] = flop_analysis.traced_flops(c.step, *c.args)
    assert flops["none"] <= flops["dots"] < flops["full"]


# ---------------------------------------------------- the kernels' routes
def _elsewhere(*xs) -> tuple:
    class Elsewhere(torch.Tensor):
        @property
        def device(self):
            return torch.device("xpu")
    return tuple(torch.Tensor._make_subclass(Elsewhere, x) for x in xs)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_routes(causal):
    """cpu: the plain version; meta: an empty output of the kernel's shape
    and dtype, and the call's operations added to ``meta_flops``; any
    other device raises."""
    gen = torch.Generator().manual_seed(0)
    q = torch.randn(2, 4, 12, 16, generator=gen)
    k, v = (torch.randn(2, 2, 20, 16, generator=gen) for _ in range(2))
    assert torch.equal(fa.flash_attention(q, k, v, causal=causal),
                       attention_ref(q, k, v, causal=causal))
    before = fa.flash_attention.meta_flops
    launches = fa.flash_attention.launches
    out = fa.flash_attention(*(x.to("meta").bfloat16() for x in (q, k, v)),
                             causal=causal, s_valid=15)
    assert out.device.type == "meta" and out.shape == q.shape
    assert out.dtype == torch.bfloat16
    pairs = sum(min(i + 1, 15) for i in range(12)) if causal else 12 * 15
    assert fa.flash_attention.meta_flops - before == 4 * 2 * 4 * 16 * pairs
    assert fa.flash_attention.launches == launches
    with pytest.raises(ValueError, match="no kernel for device"):
        fa.flash_attention(*_elsewhere(q, k, v), causal=causal)


def test_ssm_scan_routes():
    gen = torch.Generator().manual_seed(0)
    x, dt = (torch.randn(2, 9, 6, generator=gen) for _ in range(2))
    bm, cm = (torch.randn(2, 9, 4, generator=gen) for _ in range(2))
    a = -torch.rand(6, 4, generator=gen)
    got = ss.ssm_scan(x, dt.abs(), bm, cm, a, return_state=True)
    want = ssm_scan_ref(x, dt.abs(), bm, cm, a, return_state=True)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    before = ss.ssm_scan.meta_flops
    y, h = ss.ssm_scan(*(t.to("meta") for t in (x.bfloat16(), dt.bfloat16(),
                                                 bm, cm, a)),
                       return_state=True)
    assert y.device.type == h.device.type == "meta"
    assert y.shape == x.shape and y.dtype == torch.bfloat16
    assert h.shape == (2, 6, 4) and h.dtype == torch.float32
    assert ss.ssm_scan.meta_flops - before == 6 * 2 * 9 * 6 * 4 + 2 * 9 * 6
    with pytest.raises(ValueError, match="no kernel for device"):
        ss.ssm_scan(*_elsewhere(x, dt, bm, cm, a))


def test_prefill_on_meta_counts_the_kernels():
    """A hybrid prefill on meta reaches both kernels' meta routes, one call
    a layer each, and computes nothing."""
    cfg = reduced(get_arch("hymba-1.5b"))
    _, shape = _small("prefill_32k", seq_len=24)
    c = cell.build_cell(cfg, shape, "meta", RunConfig())
    before = (fa.flash_attention.meta_flops, ss.ssm_scan.meta_flops)
    ops = flop_analysis.traced_ops(c.step, *c.args)
    attn = fa.flash_attention.meta_flops - before[0]
    scan = ss.ssm_scan.meta_flops - before[1]
    b, t, hd = 2, 24, cfg.resolved_head_dim
    assert attn == cfg.n_layers * fa.flops(b, cfg.n_heads, t, t, hd, True)
    assert scan == cfg.n_layers * ss.flops(b, t, cfg.d_inner,
                                           cfg.ssm.d_state)
    assert ops["float32"] == scan and ops["bfloat16"] > attn


def test_roofline_charges_the_scan_at_the_float32_peak(tmp_path,
                                                       monkeypatch):
    """An SSM prefill's ``compute_s``: the scan's float32 operations at
    the CUDA-core peak, the rest at the bf16 tensor-core peak."""
    from repro_torch.launch import mesh
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: reduced(get_arch(name)))
    rec = dryrun.run_cell("falcon-mamba-7b", "prefill_32k", RunConfig(),
                          tmp_path)
    assert rec["status"] == "ok", rec.get("error")
    roof = rec["roofline"]
    fp32, total = roof["fp32_flops_per_device"], roof["hlo_flops_per_device"]
    assert 0 < fp32 < total
    assert roof["compute_s"] == pytest.approx(
        (total - fp32) / mesh.PEAK_FLOPS_BF16 + fp32 / mesh.PEAK_FLOPS_FP32,
        rel=1e-12)


# --------------------------------------------------------------- dry run
def test_dryrun_cells(tmp_path, monkeypatch):
    """Each kind ``ok`` at a reduced arch, with its roofline and bytes; a
    dense arch's ``long_500k`` ``skipped`` with the reference's reason;
    the CLI exits 1 on an error."""
    monkeypatch.setattr(dryrun, "get_arch",
                        lambda name: reduced(get_arch(name)))
    run = RunConfig(remat="dots")
    for shape_name in ("train_4k", "prefill_32k", "decode_32k"):
        rec = dryrun.run_cell("granite-3-2b", shape_name, run, tmp_path)
        assert rec["status"] == "ok", rec.get("error")
        roof = rec["roofline"]
        assert roof["hlo_flops_per_device"] > 0
        assert roof["collective_s"] == 0 and rec["n_devices"] == 1
        assert roof["bound_s"] == max(roof["compute_s"], roof["memory_s"])
        assert rec["bytes"]["total"] == sum(
            v for k, v in rec["bytes"].items() if k != "total")
        assert rec["fits_80gb"] is True
        saved = json.loads((tmp_path / f"granite-3-2b__{shape_name}__h100"
                            ".json").read_text())
        assert saved["status"] == "ok"
    rec = dryrun.run_cell("granite-3-2b", "long_500k", run, tmp_path)
    from repro.configs.base import shape_applicable as j_applicable
    _, why = j_applicable(j_get_arch("granite-3-2b"), J_SHAPES["long_500k"])
    assert rec["status"] == "skipped" and rec["reason"] == why

    def broken(*a, **kw):
        raise RuntimeError("injected")
    monkeypatch.setattr(dryrun, "build_cell", broken)
    with pytest.raises(SystemExit) as exc:
        dryrun.main(["--arch", "granite-3-2b", "--shape", "decode_32k",
                     "--mesh", "h100", "--out", str(tmp_path)])
    assert exc.value.code == 1
    rec = json.loads((tmp_path / "granite-3-2b__decode_32k__h100.json")
                     .read_text())
    assert rec["status"] == "error" and "injected" in rec["error"]
