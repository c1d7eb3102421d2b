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
rounded to bf16, so an element may sit one bf16 step apart); for the
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
from repro_torch.kernels.flash_attention.kernel import flash_attention
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
]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("case", SSM_CASES)
def test_ssm_scan_matches_plain_version(cuda, case, dtype, tol):
    b, t, di, n = case
    gen = torch.Generator().manual_seed(7)
    x = torch.randn((b, t, di), generator=gen).to(dtype).to(cuda)
    dt = (0.1 * torch.randn((b, t, di), generator=gen).abs()).to(dtype) \
        .to(cuda)
    bm, cm = (torch.randn((b, t, n), generator=gen).to(cuda)
              for _ in range(2))
    a = -torch.randn((di, n), generator=gen).abs().to(cuda)
    before = ssm_scan.launches
    y, h = ssm_scan(x, dt, bm, cm, a, return_state=True)
    assert ssm_scan.launches == before + 1
    y_ref, h_ref = ssm_scan_ref(x, dt, bm, cm, a, return_state=True)
    torch.cuda.synchronize()
    assert y.dtype == dtype and y.shape == x.shape
    assert h.dtype == torch.float32 and h.shape == (b, di, n)
    torch.testing.assert_close(y.float(), y_ref.float(), rtol=tol, atol=tol)
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
