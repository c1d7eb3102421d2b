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
matrix (one fixed summation order per element).
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
                                  "hymba-1.5b"])
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
