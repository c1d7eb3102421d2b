"""The port on the card: CUDA paths against their CPU twins.

Marked ``gpu``: each test skips without a CUDA device.  On the card run
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.
This file imports no JAX, so it runs where only PyTorch is installed;
the CPU side it compares with is itself held against JAX by the other
``tests/test_torch_*.py`` files.  Tolerances: none for the delta probe
and the train launcher, bit for bit, since the probe is an integer XOR and
the launcher is deterministic on the card; for the flash-attention kernel
against its plain version on the card, ``tests/test_kernels.py``'s 2e-5
(f32: the same arithmetic in another order) and 2e-2 (bf16: the output is
rounded to bf16, so an element may sit one bf16 step apart, and P enters
the tensor cores' P.V in bf16), and bit for bit between a strided and a
contiguous call (the same arithmetic on the same values); for the
selective-scan kernel, 2e-4 (f32: the same recurrence, exponentials and
sums rounded in another order) and 2e-2 for a bf16 y, with the f32 final
state at 2e-4 either way; for the three one-shot delta kernels, bit for
bit (integer XOR); for the correlation kernel, 1e-5 against its plain
version (``tests/test_kernels.py``'s limit: float32 sums in another
order), and bit for bit between a strip and the same rows of the full
matrix (one fixed summation order per element); for the uplink's int8
quantizer and its images, bit for bit against the CPU (IEEE division and
round half to even on both), and the refs an encoder on the card writes
equal the CPU encoder's; for the encoder–decoder on the card against the
CPU, 2e-5 (f32: the same arithmetic in another order) and 2e-2 (bf16) of
the largest value, its bf16 caches one bf16 step apart at most; for a
cell on a (1, 1) card mesh against the same cell on the card, bit for bit
(the same local arithmetic on the same values).
"""
from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from repro_torch import tree as tu
from repro_torch.core.chunkstore import ChunkStore
from repro_torch.core.snapshots import SnapshotManager
from repro_torch.kernels.delta_encode import ops
from repro_torch.kernels.delta_encode.kernel import (as_i32_tiles,
                                                     changed_bitmap,
                                                     delta_apply,
                                                     delta_encode,
                                                     fused_delta_tiles)
from repro_torch.kernels.delta_encode.ref import (changed_bitmap_ref,
                                                  delta_apply_ref,
                                                  delta_encode_ref,
                                                  fused_tiles_ref)
from repro_torch.kernels.flash_attention import ops as attn_ops
from repro_torch.kernels.flash_attention.kernel import (HEAD_DIMS,
                                                        flash_attention)
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.pcor.kernel import pcor
from repro_torch.kernels.pcor.ops import correlate, pcor_strip
from repro_torch.kernels.pcor.ref import pcor_ref
from repro_torch.kernels.ssm_scan.kernel import ssm_scan
from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _leaf(dtype: torch.dtype, n: int, gen: torch.Generator) -> torch.Tensor:
    if dtype.is_floating_point:
        return torch.randn(n, generator=gen).to(dtype)
    return torch.randint(-1000, 1000, (n,), generator=gen).to(dtype)


@pytest.mark.parametrize("dtype", ops.KERNEL_DTYPES)
def test_kernel_matches_plain_version(cuda, dtype):
    gen = torch.Generator().manual_seed(17)
    old = _leaf(ops.dtype_from_name(dtype), 3 * 16384 + 11, gen)
    new = old.clone()
    bits = new.view(torch.int16 if new.element_size() == 2 else torch.int32)
    bits[[0, 2 * 16384 + 5]] ^= 1
    o32, _ = as_i32_tiles(old.to(cuda))
    n32, _ = as_i32_tiles(new.to(cuda))
    before = fused_delta_tiles.launches
    bm, tiles = fused_delta_tiles(o32, n32)
    assert fused_delta_tiles.launches == before + 1
    bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
    torch.cuda.synchronize()
    k = int(bm_ref.sum())
    assert k >= 1
    assert torch.equal(bm, bm_ref) and torch.equal(tiles[:k], tiles_ref)


@pytest.mark.parametrize("dtype", ops.KERNEL_DTYPES)
def test_one_shot_delta_kernels_match_plain_versions(cuda, dtype):
    gen = torch.Generator().manual_seed(18)
    old = _leaf(ops.dtype_from_name(dtype), 5 * 16384 + 7, gen)
    new = old.clone()
    bits = new.view(torch.int16 if new.element_size() == 2 else torch.int32)
    flipped = [3, 3 * 16384 + 1, 5 * 16384 + 6]
    bits[flipped] ^= 4
    per_tile = 8192 * 4 // new.element_size()
    o32, _ = as_i32_tiles(old.to(cuda))
    n32, _ = as_i32_tiles(new.to(cuda))
    before = [k.launches for k in (changed_bitmap, delta_encode,
                                   delta_apply)]
    bm = changed_bitmap(o32, n32)
    delta, bm2 = delta_encode(o32, n32)
    back = delta_apply(o32, delta)
    assert [k.launches for k in (changed_bitmap, delta_encode,
                                 delta_apply)] == [n + 1 for n in before]
    delta_ref, bm_ref = delta_encode_ref(o32, n32)
    torch.cuda.synchronize()
    assert bm_ref.nonzero().flatten().tolist() == sorted(
        {i // per_tile for i in flipped})
    assert torch.equal(bm, changed_bitmap_ref(o32, n32))
    assert torch.equal(bm, bm_ref) and torch.equal(bm2, bm_ref)
    assert torch.equal(delta, delta_ref)
    assert torch.equal(back, delta_apply_ref(o32, delta_ref))
    assert torch.equal(back, n32)


@pytest.mark.parametrize("nblk", [1, 7, 12321])
def test_delta_apply_matches_plain_version(cuda, nblk):
    """One tile, an odd tile count, and a leaf one tile above the largest
    leaf of the train state's launches (12,320 tiles), bit for bit."""
    gen = torch.Generator().manual_seed(nblk)
    o32, d32 = (torch.randint(-2 ** 31, 2 ** 31 - 1, (nblk, 8, 1024),
                              dtype=torch.int32, generator=gen).to(cuda)
                for _ in range(2))
    before = delta_apply.launches
    new = delta_apply(o32, d32)
    assert delta_apply.launches == before + 1
    assert torch.equal(new, delta_apply_ref(o32, d32))
    assert torch.equal(new ^ d32, o32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_one_shot_delta_api_matches_cpu(cuda, dtype):
    gen = torch.Generator().manual_seed(19)
    old = torch.randn(40001, generator=gen).to(ops.dtype_from_name(dtype))
    new = old.clone()
    new[[0, 17000, 40000]] = float("nan")
    new[5] = -0.0
    tiles, bitmap, n = ops.diff_blocks(old.to(cuda), new.to(cuda))
    want = ops.diff_blocks(old, new)
    np.testing.assert_array_equal(tiles, want[0])
    np.testing.assert_array_equal(bitmap, want[1])
    assert n == want[2]
    rec = ops.patch_blocks(old.to(cuda), tiles, bitmap)
    assert rec.device.type == "cuda" and rec.dtype == old.dtype
    assert torch.equal(rec.cpu().view(torch.uint8), new.view(torch.uint8))
    for fused in (True, False):
        got = ops.changed_blocks(old.to(cuda), new.to(cuda), fused=fused)
        np.testing.assert_array_equal(got[0], tiles)
        np.testing.assert_array_equal(got[1], bitmap)


def test_host_image_against_card_leaf_runs_on_the_card(cuda):
    """The uplink's pair: an old image on the host, the new leaf live on
    the card.  Both one-shot entry points diff where ``new`` lies."""
    gen = torch.Generator().manual_seed(20)
    old = torch.randn(3 * 8192 + 5, generator=gen)
    new = old.clone()
    new[[1, 2 * 8192 + 3]] += 1.0
    want = ops.diff_blocks(old, new)
    before = delta_encode.launches
    got = ops.diff_blocks(old, new.to(cuda))
    assert delta_encode.launches == before + 1
    before = [fused_delta_tiles.launches, changed_bitmap.launches]
    fused = ops.changed_blocks(old, new.to(cuda))
    unfused = ops.changed_blocks(old, new.to(cuda), fused=False)
    assert [fused_delta_tiles.launches, changed_bitmap.launches] == \
        [n + 1 for n in before]
    for tiles, bitmap, _ in (got, fused, unfused):
        np.testing.assert_array_equal(tiles, want[0])
        np.testing.assert_array_equal(bitmap, want[1])


def _tree(gen) -> dict:
    return {"tiny": torch.randn(500, generator=gen),
            "whole": torch.randn(8192 * 3, generator=gen),
            "mid": torch.randn(33000, generator=gen),
            "half": torch.randn(4097, generator=gen).half(),
            "idx": torch.randint(0, 9, (77,), generator=gen,
                                 dtype=torch.int32)}


@pytest.mark.parametrize("bucketed", [True, False])
def test_probe_leaves_matches_cpu(cuda, bucketed):
    gen = torch.Generator().manual_seed(3)
    cpu = _tree(gen)
    dev = {k: v.to(cuda) for k, v in cpu.items()}
    mc, md = ops.DeviceMirror(), ops.DeviceMirror()
    for rnd in range(3):
        if rnd:
            for tree in (cpu, dev):        # the same in-place updates
                tree["whole"][8192 + 7] += 1.0
                tree["mid"].add_(0.5)
                tree["half"][4096] = 3.0
        want = ops.probe_leaves(cpu, mirror=mc, bucketed=bucketed)
        got = ops.probe_leaves(dev, mirror=md, bucketed=bucketed)
        assert got.keys() == want.keys()
        for key, w in want.items():
            if w is None:
                assert got[key] is None
                continue
            np.testing.assert_array_equal(got[key][0], w[0])
            np.testing.assert_array_equal(got[key][1], w[1])
        if rnd:
            assert got["whole"][1].tolist() == [0, 1, 0]
            assert not got["tiny"][1].any()


def test_snapshot_manifests_and_restore_match_cpu(cuda):
    gen = torch.Generator().manual_seed(4)
    states = [_tree(gen)]
    for _ in range(2):
        nxt = {k: v.clone() for k, v in states[-1].items()}
        nxt["mid"][100:200] += 1.0
        nxt["whole"][-1] = 0.0
        states.append(nxt)
    mans = []
    for device in ("cpu", cuda):
        mgr = SnapshotManager(ChunkStore(chunk_bytes=1 << 15), keep_last=5)
        for i, st in enumerate(states):
            mgr.snapshot(tu.tree_map(lambda t: t.to(device), st), step=i)
        out, _ = mgr.restore(device=device)
        for key, t in tu.flatten_with_keys(states[-1]):
            assert out[key].device.type == torch.device(device).type
            assert torch.equal(out[key].cpu(), t)
        dicts = [json.loads(mgr.manifests[s].to_json()) for s in mgr.order]
        mans.append([{k: v for k, v in d.items() if k != "created"}
                     for d in dicts])
        mgr.close()
    assert mans[0] == mans[1]


def test_launcher_resume_is_bit_exact_on_the_card(cuda, tmp_path):
    from repro_torch.launch import train
    out = str(tmp_path / "run")
    a = train.main(["--steps", "4", "--snapshot-every", "2", "--outdir",
                    out])
    r = train.main(["--steps", "2", "--snapshot-every", "2", "--outdir",
                    out, "--resume"])
    full = train.main(["--steps", "6", "--snapshot-every", "2"])
    assert a["device"].startswith("cuda")
    assert a["losses"] + r["losses"] == full["losses"]


def test_restore_latest_defaults_to_the_card(cuda):
    """A trainer on the card restores onto the card when ``device`` is not
    given: every later round, its probe included, stays there."""
    from test_torch_train import _restore_without_device
    taken, restored, nxt = _restore_without_device("cuda")
    assert nxt == 2
    for want, got in zip(taken, restored, strict=True):
        assert got.device.type == "cuda"
        assert torch.equal(got.reshape(-1).view(torch.uint8),
                           want.reshape(-1).view(torch.uint8))


ATTN_CASES = [
    # (B, T, S, H, K, hd, causal): tests/test_kernels.py's cases, then the
    # reduced configs' hd 16 and granite-3-2b's prefill heads
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 384, 8, 8, 32, False),
    (2, 200, 200, 6, 3, 64, True),
    (1, 96, 96, 4, 1, 128, False),
    (1, 64, 64, 2, 2, 256, True),
    (2, 37, 37, 4, 2, 16, True),
    (1, 333, 333, 32, 8, 64, True),
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", ATTN_CASES)
def test_flash_attention_matches_plain_version(cuda, case, dtype, tol):
    b, t, s, h, kh, hd, causal = case
    gen = torch.Generator().manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen).to(dtype).to(cuda)
               for shape in ((b, h, t, hd), (b, kh, s, hd), (b, kh, s, hd)))
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal)
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=tol, atol=tol)


BF16_CASES = [
    # (B, T, S, H, K, hd, causal): every head size, causal with a ragged
    # T and non-causal with S > T; then hymba-1.5b's group of 5 (25/5
    # heads) and granite-3-2b's prefill heads at B 8, T 2048
    *((2, 150, 150, 4, 2, hd, True) for hd in HEAD_DIMS),
    *((1, 100, 230, 4, 2, hd, False) for hd in HEAD_DIMS),
    (1, 97, 97, 25, 5, 64, True),
    (2, 333, 333, 25, 5, 64, True),
    (8, 2048, 2048, 32, 8, 64, True),
]


@pytest.mark.parametrize("case", BF16_CASES)
def test_flash_attention_bf16_matches_plain_version(cuda, case):
    b, t, s, h, kh, hd, causal = case
    gen = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(shape, generator=gen).bfloat16().to(cuda)
               for shape in ((b, h, t, hd), (b, kh, s, hd), (b, kh, s, hd)))
    out = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == q.shape
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


@pytest.mark.parametrize("hd", HEAD_DIMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_reads_strided_views_in_place(cuda, hd, dtype):
    """The model's (B, T, H, hd) tensors, and slices of one fused
    (B, T, H + 2K, hd) tensor, go in as transposed views: the output,
    written through its own strides, equals the contiguous call's bit for
    bit, and each call is one launch."""
    b, t, h, kh = 2, 200, 8, 2
    gen = torch.Generator().manual_seed(8)
    fused = torch.randn((b, t, h + 2 * kh, hd), generator=gen).to(dtype) \
        .to(cuda)
    q, k, v = (fused[:, :, :h], fused[:, :, h:h + kh], fused[:, :, h + kh:])
    want = flash_attention(*(x.transpose(1, 2).contiguous()
                             for x in (q, k, v)), causal=True)
    out = torch.empty((b, t, h, hd), dtype=dtype, device=cuda)
    before = flash_attention.launches
    got = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                          v.transpose(1, 2), causal=True,
                          out=out.transpose(1, 2))
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.data_ptr() == out.data_ptr()
    assert torch.equal(out.transpose(1, 2), want)
    assert torch.equal(attn_ops.attend(q, k, v, causal=True),
                       want.transpose(1, 2))


def test_flash_attention_masks_keys_past_s_valid(cuda):
    gen = torch.Generator().manual_seed(6)
    q = torch.randn((1, 4, 100, 32), generator=gen).to(cuda)
    k, v = (torch.randn((1, 2, 128, 32), generator=gen).to(cuda)
            for _ in range(2))
    out = flash_attention(q, k, v, causal=False, s_valid=100)
    want = attention_ref(q, k[:, :, :100], v[:, :, :100], causal=False)
    torch.testing.assert_close(out, want, rtol=2e-5, atol=2e-5)


SSM_CASES = [
    # (B, T, Di, N): tests/test_kernels.py's cases, then N 1, 2 and 32 and
    # hymba-1.5b's and falcon-mamba-7b's prefill widths
    (2, 64, 256, 16), (1, 50, 130, 8), (3, 32, 128, 16), (2, 128, 384, 4),
    (1, 33, 257, 16), (2, 19, 70, 1), (1, 40, 33, 2), (2, 45, 100, 32),
    (1, 333, 3200, 16), (2, 97, 8192, 16),
    # the scan design's edges: N 5 and 24 (no power of two), T 1, Di no
    # multiple of a block's channels at one lane (128) and at two (64)
    (2, 45, 100, 5), (1, 200, 300, 24), (1, 1, 64, 16), (2, 1, 3200, 16),
    (8, 64, 200, 16), (1, 333, 3201, 16),
    # at hymba-1.5b's width on a 132-SM card the launch rule cuts these
    # into 3 time chunks whose last one is a whole chunk (64, 64, 64), one
    # step (96, 96, 1) and a chunk less one (96, 96, 95)
    (1, 192, 3200, 16), (1, 193, 3200, 16), (1, 287, 3200, 16),
]
# B 1, T 8192 at hymba-1.5b's width: the longest carry chain
SSM_LONG = (1, 8192, 3200, 16)


def _ssm_inputs(case, dtype, cuda, seed=7, model_a=False):
    """``tests/test_kernels.py``'s distribution (dt small and positive,
    a < 0); ``model_a``: a as the SSM block initialises it,
    -exp(log(1..N)) on every channel."""
    b, t, di, n = case
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((b, t, di), generator=gen).to(dtype).to(cuda)
    dt = (0.1 * torch.randn((b, t, di), generator=gen).abs()).to(dtype) \
        .to(cuda)
    bm, cm = (torch.randn((b, t, n), generator=gen).to(cuda)
              for _ in range(2))
    a = -torch.randn((di, n), generator=gen).abs().to(cuda)
    if model_a:
        a = -torch.arange(1, n + 1, dtype=torch.float32).expand(di, n) \
            .contiguous().to(cuda)
    return x, dt, bm, cm, a


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_matches_plain_version(cuda, case, dtype, tol):
    b, t, di, n = case
    x, dt, bm, cm, a = _ssm_inputs(case, dtype, cuda)
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    assert ssm_scan.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(x, dt, bm, cm, a, return_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (b, di, n)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssm_scan_long_carry_chain(cuda, dtype):
    """T 8192 through every chunk's carry, a drawn as in
    ``tests/test_kernels.py``: the final state within 2e-4 of the plain
    version, and a bf16 y within 2e-2.  (Some a lie within 1e-4 of 0, so
    memories outlast T; there the plain version's own f32 rounding of y is
    farther than 2e-4 from float64, and ``chip_smoke.py`` records the f32
    y against both.)"""
    x, dt, bm, cm, a = _ssm_inputs(SSM_LONG, dtype, cuda)
    y, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    y_ref, h_ref = ssm_scan_ref(x, dt, bm, cm, a, return_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and bool(torch.isfinite(y).all())
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)
    if dtype == torch.bfloat16:
        torch.testing.assert_close(y.float(), y_ref.float(), rtol=2e-2,
                                   atol=2e-2)


def test_ssm_scan_long_carry_chain_at_the_models_decays(cuda):
    """T 8192 with a as the SSM block initialises it: y and the final
    state within 2e-4 of the plain version."""
    x, dt, bm, cm, a = _ssm_inputs(SSM_LONG, torch.float32, cuda,
                                   model_a=True)
    y, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    y_ref, h_ref = ssm_scan_ref(x, dt, bm, cm, a, return_state=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(h, h_ref, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  "hymba-1.5b", "deepseek-moe-16b"])
def test_engine_on_the_card_prefills_through_the_kernel(cuda, arch):
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    from repro_torch.serving.engine import Request, ServingEngine
    cfg = reduced(get_arch(arch))
    params = init_tree(api.param_specs(cfg),
                       torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    run = RunConfig(remat="none", compute_dtype=torch.float32)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, plen)
                    .astype(np.int32), gen)
            for i, (plen, gen) in enumerate([(8, 6), (12, 4), (5, 8)])]
    flash_attention.launches = ssm_scan.launches = 0
    engine = ServingEngine(cfg, params, slots=2, max_len=64, run=run)
    done = engine.run_queue(reqs)
    per_kernel = cfg.n_layers * len(reqs)
    assert flash_attention.launches == per_kernel * (cfg.family != "ssm")
    assert ssm_scan.launches == per_kernel * (cfg.family in ("ssm",
                                                             "hybrid"))
    assert engine.stats["served"] == len(reqs)
    prefill = api.make_prefill_step(cfg, 64, run)
    for req in done:
        logits, _ = prefill(engine.params, {"tokens": req.prompt[None, :]})
        assert req.output[0] == int(torch.argmax(logits[0, :cfg.vocab_size]))
        assert len(req.output) == req.max_new_tokens


@pytest.mark.parametrize("arch", ["granite-3-2b", "falcon-mamba-7b",
                                  "hymba-1.5b", "deepseek-moe-16b"])
def test_the_engines_decode_graph_serves_the_eager_engines_tokens(
        cuda, arch, monkeypatch):
    """The engine on the card captures its decode step at the first step
    and replays it at every later one: the same tokens and the same final
    pool caches, bit for bit, as an engine whose eligibility check is
    patched to refuse the graph (the same kernels on the same values).  A
    call with other caches runs eagerly and leaves the captured pool as it
    was."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    from repro_torch.serving import engine as serving
    cfg = reduced(get_arch(arch))
    params = init_tree(api.param_specs(cfg),
                       torch.Generator(device=cuda).manual_seed(0),
                       device=cuda)
    run = RunConfig(remat="none", compute_dtype=torch.bfloat16)

    def serve():
        rng = np.random.default_rng(0)
        reqs = [serving.Request(i, rng.integers(0, cfg.vocab_size, plen)
                                .astype(np.int32), gen)
                for i, (plen, gen) in enumerate([(8, 6), (12, 4), (5, 9),
                                                 (20, 3), (7, 5)])]
        engine = serving.ServingEngine(cfg, params, slots=2, max_len=64,
                                       run=run)
        done = engine.run_queue(reqs)
        torch.cuda.synchronize()
        return engine, {r.request_id: r.output for r in done}

    graphed, tokens = serve()
    with monkeypatch.context() as m:
        m.setattr(serving, "graphable", lambda params, caches: False)
        eager, want = serve()
    steps = graphed.stats["decode_steps"]
    assert steps == eager.stats["decode_steps"] and steps > 2
    assert graphed.stats["decode_graph_replays"] == steps - 1
    assert eager.stats["decode_graph_replays"] == 0
    assert tokens == want
    for a, b in zip(tu.leaves(graphed.caches), tu.leaves(eager.caches)):
        assert torch.equal(a, b)

    pool = tu.tree_map(torch.clone, graphed.caches)
    other = tu.tree_map(torch.clone, graphed.caches)
    batch = {"tokens": np.ones((2, 1), np.int32),
             "index": np.asarray([3, 5], np.int32)}
    logits, out = graphed._decode(graphed.params, other, batch)
    torch.cuda.synchronize()
    assert out is other and logits.shape[:2] == (2, 1)
    assert graphed.stats["decode_graph_replays"] == steps - 1
    assert all(torch.equal(a, b) for a, b in
               zip(tu.leaves(graphed.caches), tu.leaves(pool)))
    assert not all(torch.equal(a, b) for a, b in
                   zip(tu.leaves(other), tu.leaves(pool)))


def test_a_decode_step_that_cannot_be_captured_runs_eagerly(cuda):
    """A step that reads a value back to the host cannot be captured: the
    first call's eager step stands, a warning says why, the current stream
    is the caller's again, and every later call runs eagerly, unreplayed
    (the caches take each step once)."""
    from repro_torch.core.telemetry import Counter, Telemetry
    from repro_torch.serving.engine import DecodeGraph

    def decode(params, caches, batch):
        n = int(batch["index"].sum())            # a readback
        caches["c"].add_(params["embed"] * n)
        return caches["c"] * 2, caches
    params = {"embed": torch.ones(4, device=cuda)}
    caches = {"c": torch.zeros(4, device=cuda)}
    batch = {"tokens": np.zeros((4, 1), np.int32),
             "index": np.arange(4, dtype=np.int32)}
    replays = Counter("decode_graph_replays")
    graph = DecodeGraph(decode, replays, Telemetry())
    stream = torch.cuda.current_stream()
    with pytest.warns(UserWarning, match="runs eagerly"):
        first, _ = graph(params, caches, batch)
    assert torch.cuda.current_stream() == stream
    second, out = graph(params, caches, batch)
    torch.cuda.synchronize()
    assert out is caches and graph.graph is None and replays.value == 0
    assert first.tolist() == [12.0] * 4 and second.tolist() == [24.0] * 4
    assert caches["c"].tolist() == [12.0] * 4


PCOR_CASES = [(150, 321), (256, 128), (100, 50), (64, 7), (1000, 321),
              (129, 1)]


@pytest.mark.parametrize("g,s", PCOR_CASES)
def test_pcor_matches_plain_version(cuda, g, s):
    gen = torch.Generator().manual_seed(g + s)
    x = torch.randn((g, s), generator=gen).to(cuda)
    x[g // 2] = 0.0                        # an all-zero row: 0 either way
    before = pcor.launches
    full = correlate(x)
    assert pcor.launches == before + 1
    want = pcor_ref(x)
    torch.cuda.synchronize()
    assert full.shape == (g, g) and full.dtype == torch.float32
    torch.testing.assert_close(full, want, rtol=1e-5, atol=1e-5)
    assert not full[g // 2].any() and not full[:, g // 2].any()
    if s > 1:
        diag = full.diagonal()
        keep = torch.arange(g, device=cuda) != g // 2
        torch.testing.assert_close(diag[keep], torch.ones_like(diag[keep]),
                                   rtol=0, atol=1e-5)
    for r0, rc in ((0, g // 2), (g // 2, g - g // 2), (g // 3, 5)):
        assert torch.equal(pcor_strip(x, r0, rc), full[r0:r0 + rc])
    assert torch.equal(full, full.T)


# strips of the canonical-orientation design: starts inside a 128-row
# tile (as SPRINT's 5500 lies inside tile 42), a strip across the
# diagonal tile of its own rows, one row, the last row, the whole matrix;
# G 300 leaves a ragged last tile of 44 rows (and 16-byte stores), G 301 a
# width that is no multiple of 4 (word stores); S 1, 7 and 321 pad to
# 16, 16 and 336 samples
PCOR_STRIPS = [(172, 50), (100, 200), (5, 250), (137, 1), (128, 128),
               (255, 2)]


@pytest.mark.parametrize("s", [1, 7, 321])
@pytest.mark.parametrize("g", [300, 301])
def test_pcor_strips_equal_the_full_matrix_bit_for_bit(cuda, g, s):
    rng = np.random.default_rng(g * 1000 + s)
    x = torch.from_numpy(rng.standard_normal((g, s)).astype(np.float32))
    x = x.to(cuda)
    full = correlate(x)
    torch.cuda.synchronize()
    assert torch.equal(full, full.T)
    torch.testing.assert_close(full, pcor_ref(x), rtol=1e-5, atol=1e-5)
    if s > 1:
        torch.testing.assert_close(full.diagonal(),
                                   torch.ones(g, device=cuda), rtol=0,
                                   atol=1e-5)
    for r0, rc in PCOR_STRIPS + [(g - 1, 1), (0, g)]:
        strip = pcor_strip(x, r0, rc)
        assert strip.shape == (rc, g)
        assert torch.equal(strip, full[r0:r0 + rc]), (r0, rc)


def _tile_pair(nblk: int, pattern: str, gen: torch.Generator, cuda):
    old = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                        dtype=torch.int32, generator=gen).to(cuda)
    new = old.clone()
    if pattern == "all":
        new ^= 1
    elif pattern == "first_last":
        new[0, 0, 0] ^= 1
        new[-1, -1, -1] ^= 1
    elif pattern == "random10":
        new[torch.randperm(nblk, generator=gen)[:nblk // 10].to(cuda),
            3, 5] ^= 1
    return old, new


@pytest.mark.parametrize("pattern", ["none", "all", "first_last",
                                     "random10"])
def test_fused_delta_tiles_over_many_waves_of_blocks(cuda, pattern):
    """20,011 tiles are many waves of the look-back's blocks; the second
    call in a row gets the first one's freed scratch back from the
    caching allocator, whose status words the entry point zeroes."""
    gen = torch.Generator().manual_seed(23)
    o32, n32 = _tile_pair(20_011, pattern, gen, cuda)
    bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
    k = int(bm_ref.sum())
    for _ in range(2):
        bm, tiles = fused_delta_tiles(o32, n32)
        torch.cuda.synchronize()
        assert torch.equal(bm, bm_ref)
        assert torch.equal(tiles[:k], tiles_ref)
        del bm, tiles


def _grad_rounds(device) -> list:
    """Three rounds of f32 gradient trees on ``device``: one leaf changes
    everywhere, one in a single block, one never, one odd-sized in its
    tail (numpy from a seed, so the CPU twin gets the same bits)."""
    rng = np.random.default_rng(11)
    r = {"dense": rng.standard_normal(300_000).astype(np.float32),
         "sparse": rng.standard_normal(500_000).astype(np.float32),
         "frozen": rng.standard_normal((300, 77)).astype(np.float32),
         "odd": rng.standard_normal(40_999).astype(np.float32)}
    rounds = [r]
    for i in range(1, 3):
        cur = {k: v.copy() for k, v in rounds[-1].items()}
        cur["dense"] = rng.standard_normal(300_000).astype(np.float32)
        cur["sparse"][1000 * i:1000 * i + 40] *= 3.0
        cur["odd"][-5:] += 1.0
        rounds.append(cur)
    return [{k: torch.from_numpy(v).to(device) for k, v in g.items()}
            for g in rounds]


def test_quantized_image_on_the_card_equals_the_cpus(cuda):
    """q, scale, the carried residual and the uplink image: the card's
    bytes are the CPU's (quorum compares replicas bit for bit)."""
    from repro_torch.core.uplink import flatten_compressed, leaf_image
    from repro_torch.optim import grad_compress as gc
    g = _grad_rounds("cpu")[0]
    g["halves"] = torch.arange(-300, 212, dtype=torch.float32) / 2
    g["tiny"] = torch.randn(700, generator=torch.Generator()
                            .manual_seed(1)) * 1e-13
    g["huge"] = torch.tensor([3.4e38, -3.4e38, 1e-30, 5.0] * 70)
    gd = {k: v.cuda() for k, v in g.items()}
    c_cpu, e_cpu = gc.compress(g, gc.init_error(g))
    c_gpu, e_gpu = gc.compress(gd, gc.init_error(gd))
    for key, c in flatten_compressed(c_cpu).items():
        d = flatten_compressed(c_gpu)[key]
        assert d.q.is_cuda
        assert torch.equal(leaf_image(d).cpu(), leaf_image(c)), key
    for k in g:
        assert torch.equal(e_gpu[k].cpu().view(torch.int32),
                           e_cpu[k].view(torch.int32)), k


def test_uplink_diff_on_the_card_launches_fused_delta_tiles(cuda):
    """Three rounds through an encoder on the card: one kernel launch per
    leaf of each round after the first (4 + 4), and the same store refs
    as the encoder on the CPU."""
    from repro_torch.core.uplink import UplinkEncoder
    from repro_torch.optim import grad_compress as gc
    encs = {"cpu": UplinkEncoder(chunk_bytes=1 << 12),
            "cuda": UplinkEncoder(chunk_bytes=1 << 12)}
    refs = {}
    for dev, enc in encs.items():
        fused_delta_tiles.launches = 0
        out = []
        for g in _grad_rounds(dev):
            comp, _ = gc.compress(g, gc.init_error(g))
            out.append(enc.encode(comp).refs)
        refs[dev] = out
        assert enc.diffs == 8
        if dev == "cuda":
            assert fused_delta_tiles.launches == 8
    assert refs["cuda"] == refs["cpu"]


def test_uplink_launcher_on_the_card_diffs_every_leaf_in_the_kernel(cuda):
    """``--uplink --compress-grads`` on the card: every leaf diff of every
    worker's later units is one ``fused_delta_tiles`` launch, the server
    accepts every unit, and it folds the last unit to the quorum's hash."""
    from repro_torch.core.elastic import grad_hash
    from repro_torch.launch import train
    from repro_torch.optim import grad_compress as gc
    args = train.parse_args(["--uplink", "--compress-grads", "--steps", "3",
                             "--snapshot-every", "0"])
    sess = train.build_trainer(train.build_arch(args.arch, args.preset),
                               args)
    fused_delta_tiles.launches = 0
    summary = train.train(sess, args)
    encs = sess.trainer._uplink_enc.values()
    n_leaves = len(tu.leaves(sess.trainer.state.params))
    diffed_units = sum(e.units - 1 for e in encs)
    assert fused_delta_tiles.launches == sum(e.diffs for e in encs) \
        == n_leaves * diffed_units > 0
    assert summary["uplink"]["accepted"] == 6
    assert summary["uplink"]["rejected"] == 0
    last = max(sess.server.projects["train"].canonical_updates)
    dec = sess.server.resolve_round_update("train", last)
    params = sess.trainer.state.params
    flat = dict(tu.flatten_with_keys(params))
    grads = tu.unflatten_like(params, {
        k: gc.decompress_leaf(dec[k], flat[k].shape) for k in flat})
    assert grad_hash(grads) == sess.trainer.sched.units[last].canonical


# ------------------------------------------------------------- training
@pytest.fixture
def deterministic(cuda):
    """The train launcher's settings on the card (``resolve_device``:
    deterministic algorithms, TF32 off), put back as they were after."""
    from repro_torch.launch.train import resolve_device
    saved = (torch.are_deterministic_algorithms_enabled(),
             torch.is_deterministic_algorithms_warn_only_enabled(),
             torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    resolve_device("cuda")
    yield cuda
    torch.use_deterministic_algorithms(saved[0], warn_only=saved[1])
    torch.backends.cuda.matmul.allow_tf32 = saved[2]
    torch.backends.cudnn.allow_tf32 = saved[3]


def _grads_of(fn, params: dict, x: torch.Tensor):
    """fn(params, x) -> (y, metrics); -> (y, metrics, grads of
    sum(y**2) + moe_aux + moe_zloss by params leaf, then x)."""
    keys = [k for k, _ in tu.flatten_with_keys(params)]
    leaves = [p.detach().requires_grad_(True) for p in tu.leaves(params)]
    x = x.detach().requires_grad_(True)
    y, m = fn(tu.unflatten_like(params, dict(zip(keys, leaves))), x)
    loss = torch.sum(y.float() ** 2) + m["moe_aux"] + m["moe_zloss"]
    grads = torch.autograd.grad(loss, leaves + [x])
    return y.detach(), {k: v.detach() for k, v in m.items()}, \
        dict(zip(keys + ["x"], grads))


def test_moe_on_the_card_is_deterministic_and_matches_cpu(deterministic):
    """``moe_apply`` forward and backward under the launcher's
    deterministic mode at deepseek-moe-16b's routing (64 experts, 2
    shared, top 6) and a narrow width, with drops (capacity 7 of 24
    items an expert on average): two runs on the card bit for bit, and
    within 2e-5 of the CPU in float32 (``tests/test_kernels.py``'s limit:
    the same arithmetic in another order)."""
    import dataclasses

    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.moe.moe import moe_apply, moe_specs
    full = get_arch("deepseek-moe-16b")
    cfg = dataclasses.replace(reduced(full, d_model=256),
                              moe=dataclasses.replace(full.moe,
                                                      d_ff_expert=96))
    params = init_tree(moe_specs(cfg), torch.Generator().manual_seed(0),
                       device="cpu")
    x = torch.randn((4, 64, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))

    def fn(p, x):
        return moe_apply(p, x, cfg)
    on_card = tu.tree_map(lambda t: t.to(deterministic), params)
    runs = [_grads_of(fn, on_card, x.to(deterministic)) for _ in range(2)]
    cpu = _grads_of(fn, params, x)
    assert float(cpu[1]["moe_drop_frac"]) > 0
    for a, b in zip(tu.leaves(runs[0]), tu.leaves(runs[1]), strict=True):
        assert torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
    for got, want in zip(tu.leaves(runs[0]), tu.leaves(cpu), strict=True):
        scale = float(want.abs().max())
        torch.testing.assert_close(got.cpu(), want, rtol=2e-5,
                                   atol=2e-5 * scale)


@pytest.mark.parametrize("arch", ["falcon-mamba-7b", "hymba-1.5b"])
def test_ssm_train_step_on_the_card_matches_cpu(deterministic, arch):
    """One ``make_train_step`` in float32 through the chunked scan's
    autograd (T 21, chunk 8: a short last chunk), on the card against the
    CPU: loss, gradient norm and the updated params within 1e-5 (relative,
    with a floor of 1e-5 of the largest value, as
    ``tests/test_torch_model.py``)."""
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    cfg = reduced(get_arch(arch))
    specs = api.state_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    state = api.TrainState(init_tree(specs.params, gen, device="cpu"),
                           init_tree(specs.opt, gen, device="cpu"))
    tokens = torch.randint(0, cfg.vocab_size, (2, 22), generator=gen)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}
    step = api.make_train_step(cfg, RunConfig(
        remat="none", ssm_chunk=8, compute_dtype=torch.float32))
    want, wm = step(state, batch)
    before = ssm_scan.launches
    got, gm = step(tu.tree_map(lambda t: t.to(deterministic), state), batch)
    assert ssm_scan.launches == before
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[key].cpu(), wm[key], rtol=1e-5,
                                   atol=0.0)
    for (key, g), w in zip(tu.flatten_with_keys(got.params),
                           tu.leaves(want.params), strict=True):
        assert g.device.type == "cuda", key
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


# ------------------------------------------------------ encoder–decoder
SEAMLESS_ATTN_CASES = [
    # (B, T, S): seamless-m4t-medium's heads (16 / 16 of 64), non-causal
    # as the encoder and the cross-attention call the kernel: T = S, and a
    # ragged S shorter and longer than T
    (8, 1024, 1024), (8, 1024, 1000), (8, 1024, 1500),
]


@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("case", SEAMLESS_ATTN_CASES)
def test_flash_attention_non_causal_at_seamless_heads(cuda, case, model):
    """bf16, in the kernel's layout and through ``attend`` on the model's
    (B, T, H, hd) tensors, against the plain version within 2e-2."""
    b, t, s = case
    h, hd = 16, 64
    gen = torch.Generator().manual_seed(10)
    shapes = (((b, t, h, hd), (b, s, h, hd)) if model
              else ((b, h, t, hd), (b, h, s, hd)))
    q, k, v = (torch.randn(shape, generator=gen).bfloat16().to(cuda)
               for shape in (shapes[0], shapes[1], shapes[1]))
    before = flash_attention.launches
    if model:
        out = attn_ops.attend(q, k, v, causal=False).transpose(1, 2)
        q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    else:
        out = flash_attention(q, k, v, causal=False)
    assert flash_attention.launches == before + 1
    want = attention_ref(q, k, v, causal=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)


def _seamless():
    from repro_torch.configs.base import get_arch, reduced
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.models import api
    cfg = reduced(get_arch("seamless-m4t-medium"))
    specs = api.state_specs(cfg)
    gen = torch.Generator().manual_seed(0)
    state = api.TrainState(init_tree(specs.params, gen, device="cpu"),
                           init_tree(specs.opt, gen, device="cpu"))
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 12))
             .astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (2, 12))
             .astype(np.int32),
             "frames": rng.standard_normal((2, 20, cfg.d_model))
             .astype(np.float32)}
    return cfg, state, batch


def _scaled_close(got, want, tol):
    torch.testing.assert_close(got.float().cpu(), want.float(), rtol=tol,
                               atol=tol * float(want.float().abs().max()))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_encdec_prefill_and_decode_on_the_card_match_cpu(deterministic,
                                                         monkeypatch, dtype,
                                                         tol):
    """Reduced seamless-m4t-medium (T 12 against S 20): one prefill on the
    card is 3 x L flash-attention launches (the encoder's L and the
    cross-attention's L non-causal, the decoder's L causal); its logits
    and both bf16 caches against the CPU's, then two decode steps (no
    launch) from the CPU's caches.  The caches are held to one bf16 step
    (an element straddling a rounding boundary), and the card's prefill
    logits are taken over the CPU's rounded cross K/V, so that such a
    step does not move them past ``tol``."""
    from repro_torch.models import api, encdec
    from repro_torch.models.attention import KVCache
    from repro_torch.models.lm import RunConfig
    cfg, state, batch = _seamless()
    batch.pop("labels")
    run = RunConfig(remat="none", compute_dtype=dtype)
    prefill = api.make_prefill_step(cfg, 24, run)
    decode = api.make_decode_step(cfg, run)
    params = state.params
    card = tu.tree_map(lambda t: t.to(deterministic), params)
    want, want_caches = prefill(params, batch)
    flash_attention.launches = 0
    got, caches = prefill(card, batch)
    assert flash_attention.launches == 3 * cfg.n_layers
    cache_tol = max(tol, 2.0 ** -7)
    for name in ("self_kv", "cross_kv"):
        for g, w in zip(caches[name], want_caches[name], strict=True):
            assert g.device.type == "cuda" and g.dtype == torch.bfloat16
            _scaled_close(g, w, cache_tol)
    rounded = iter(zip(*(c.to(deterministic)
                         for c in want_caches["cross_kv"])))
    monkeypatch.setattr(encdec, "_cross_kv", lambda lp, enc_out: KVCache(
        *(c.to(enc_out.dtype) for c in next(rounded))))
    got, _ = prefill(card, batch)
    monkeypatch.undo()
    _scaled_close(got, want, tol)
    tok = np.asarray([[3], [5]], np.int32)
    launches = flash_attention.launches
    card_caches = tu.tree_map(lambda t: t.to(deterministic), want_caches)
    for i in range(2):
        want, want_caches = decode(params, want_caches,
                                   {"tokens": tok, "index": 12 + i})
        got, card_caches = decode(card, card_caches,
                                  {"tokens": tok, "index": 12 + i})
        _scaled_close(got, want, tol)
        card_caches = tu.tree_map(lambda t: t.to(deterministic),
                                  want_caches)
    assert flash_attention.launches == launches


def test_encdec_train_step_on_the_card_matches_cpu(deterministic):
    """One ``make_train_step`` in float32 (the ``blocked_attention`` twin
    throughout, no kernel launch) on the card against the CPU: loss,
    gradient norm and the updated params within 2e-5 (relative, with a
    floor of 2e-5 of the largest value)."""
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    cfg, state, batch = _seamless()
    step = api.make_train_step(cfg, RunConfig(remat="full",
                                              compute_dtype=torch.float32))
    want, wm = step(state, batch)
    before = flash_attention.launches
    got, gm = step(tu.tree_map(lambda t: t.to(deterministic), state), batch)
    assert flash_attention.launches == before
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(gm[key].cpu(), wm[key], rtol=2e-5,
                                   atol=0.0)
    for (key, g), w in zip(tu.flatten_with_keys(got.params),
                           tu.leaves(want.params), strict=True):
        assert g.device.type == "cuda", key
        torch.testing.assert_close(g.cpu(), w, rtol=2e-5,
                                   atol=2e-5 * float(w.abs().max()))


# ------------------------------------------------------- launch tooling
def test_build_cell_on_the_card_matches_cpu(deterministic):
    """A reduced granite-3-2b train cell built on the card: its step against
    the same cell built on the CPU from the same state, loss and updated
    params within 1e-5 (``tests/test_torch_model.py``'s tolerance)."""
    import dataclasses

    from repro_torch.configs.base import SHAPES, get_arch, reduced
    from repro_torch.launch.cell import build_cell
    from repro_torch.models.lm import RunConfig
    cfg = reduced(get_arch("granite-3-2b"))
    shape = dataclasses.replace(SHAPES["train_4k"], seq_len=32,
                                global_batch=2)
    run = RunConfig(remat="dots", compute_dtype=torch.float32)
    cpu = build_cell(cfg, shape, "cpu", run)
    card = build_cell(cfg, shape, deterministic, run)
    assert all(t.device.type == "cuda" for t in tu.leaves(card.args))
    state = tu.tree_map(lambda t: t.to(deterministic), cpu.args[0])
    got, gm = card.step(state, card.args[1])
    want, wm = cpu.step(*cpu.args)
    torch.testing.assert_close(gm["loss"].cpu(), wm["loss"], rtol=1e-5,
                               atol=0.0)
    for g, w in zip(tu.leaves(got.params), tu.leaves(want.params),
                    strict=True):
        torch.testing.assert_close(g.cpu(), w, rtol=1e-5,
                                   atol=1e-5 * float(w.abs().max()))


@pytest.mark.parametrize("shape_name", ["train_4k", "prefill_32k",
                                        "decode_32k"])
def test_card_mesh_cell_equals_the_card_cell(deterministic, shape_name):
    """A reduced granite-3-2b cell built on a (1, 1) ``DeviceMesh`` over an
    NCCL group of one (every argument a DTensor, the step inside the
    rules) gives the cell built on the card bit for bit: loss, updated
    state, logits and caches; a prefill launches the attention kernel
    once per layer on either."""
    import dataclasses

    from torch.distributed.tensor import DTensor

    from repro_torch.configs.base import SHAPES, get_arch, reduced
    from repro_torch.launch import mesh
    from repro_torch.launch.cell import build_cell
    from repro_torch.models.lm import RunConfig
    cfg = reduced(get_arch("granite-3-2b"), d_model=256, n_heads=4)
    shape = dataclasses.replace(SHAPES[shape_name], seq_len=64,
                                global_batch=2)
    run = RunConfig()

    def launched(c):
        flash_attention.launches = 0
        out = c.step(*c.args)
        return out, flash_attention.launches

    want, want_n = launched(build_cell(cfg, shape, deterministic, run))
    with mesh.process_group("nccl", 1):
        m = mesh.make_mesh((1, 1), ("data", "model"), device_type="cuda")
        got, got_n = launched(build_cell(cfg, shape, m, run))
        got = [(k, v.to_local() if isinstance(v, DTensor) else v)
               for k, v in tu.flatten_with_keys(got)]
    assert got_n == want_n == (cfg.n_layers if shape.kind == "prefill"
                               else 0)
    want = tu.flatten_with_keys(want)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (key, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w), key


@pytest.mark.parametrize("arch", ["granite-3-2b", "hymba-1.5b"])
def test_meta_route_gives_the_card_cells_shapes(cuda, arch):
    """A reduced prefill cell traced on meta gives the logits and caches of
    the same cell run on the card, shape for shape and dtype for dtype,
    and its kernels' meta counts equal the launches' formula counts."""
    import dataclasses

    from repro_torch.configs.base import SHAPES, get_arch, reduced
    from repro_torch.kernels.flash_attention import kernel as fa
    from repro_torch.kernels.ssm_scan import kernel as ss
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.flop_analysis import traced_flops
    cfg = reduced(get_arch(arch))
    shape = dataclasses.replace(SHAPES["prefill_32k"], seq_len=40,
                                global_batch=2)
    card = build_cell(cfg, shape, cuda)
    meta = build_cell(cfg, shape, "meta")
    launches = (flash_attention.launches, ssm_scan.launches)
    out = card.step(*card.args)
    torch.cuda.synchronize()
    assert flash_attention.launches - launches[0] == cfg.n_layers
    assert ssm_scan.launches - launches[1] == (
        cfg.n_layers if cfg.family == "hybrid" else 0)
    before = (fa.flash_attention.meta_flops, ss.ssm_scan.meta_flops)
    assert traced_flops(meta.step, *meta.args) > 0
    shapes = [(tuple(t.shape), t.dtype) for t in tu.leaves(out)]
    assert shapes == [(tuple(t.shape), t.dtype)
                      for t in tu.leaves(meta.step(*meta.args))]
    b, t = shape.global_batch, shape.seq_len
    # traced once and run once more on meta: twice the per-call counts
    assert fa.flash_attention.meta_flops - before[0] == 2 * cfg.n_layers \
        * fa.flops(b, cfg.n_heads, t, t, cfg.resolved_head_dim, True)
    if cfg.family == "hybrid":
        assert ss.ssm_scan.meta_flops - before[1] == 2 * cfg.n_layers \
            * ss.flops(b, t, cfg.d_inner, cfg.ssm.d_state)


@pytest.mark.parametrize("name", ["torch_quickstart", "torch_project_switch",
                                  "torch_serve_capsule"])
def test_examples_raise_without_a_card(name, monkeypatch):
    """Without ``--device`` an example runs on the card, and with none
    found it stops rather than carry on on the CPU (no card needed: the
    check sees ``torch.cuda.is_available`` return False)."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        mod.main()
