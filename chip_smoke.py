#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --phases build,kernel --layers 2
    python3 chip_smoke.py --phases build,ssm_kernel,serve_ssm --ssm-layers 2
    python3 chip_smoke.py --phases build,delta_ops
    python3 chip_smoke.py --phases build,sprint

Phases, each printing one JSON line:

1. ``gpu``: the card's name and power limit (``nvidia-smi``).
2. ``build``: ``nvcc`` of every kernel source of the port, in parallel;
   then the ``HGMMA`` (wgmma) instructions of each function in
   ``cuobjdump -sass`` of ``libflash_attention.so`` and ``libpcor.so``:
   every bf16 attention kernel and the correlation's tile-pair kernel
   must have some, or the phase fails; and no instantiation of the scan
   or the correlation may spill registers (``ptxas``'s spill stores and
   loads).
3. ``kernel``: ``fused_delta_tiles`` against its plain PyTorch version, bit
   for bit, on leaves of 1 and 12,320 tiles with ragged tails, every
   kernel dtype, and no / all / first-and-last / a random 10 % of tiles
   changed; then, at the training path's launch shapes, checked again and
   timed with CUDA events beside the plain version and the bytes bound
   (every tile changed: 3N), and the largest of them again with a random
   10 % of its tiles changed, beside its own bytes (2N and the changed
   tiles).
4. ``attn_kernel``: ``flash_attention`` against its plain PyTorch
   version on the card, on ``tests/test_kernels.py``'s ``ATTN_CASES`` (hd
   32 to 256, MQA, S > T, ragged T and S) plus hd 16, in f32 (2e-5) and
   bf16 (2e-2), and on every prefill shape of the serve and serve_ssm
   phases in bf16, each both in the kernel's (B, H, T, hd) layout and
   through ``ops.attend`` on the model's (B, T, H, hd) tensors, as the
   path calls it; then timed with CUDA events beside the plain version
   and ``scaled_dot_product_attention`` (the library yardstick, used
   nowhere in the port: pinned to its flash backend, and under its
   default dispatch, whose backend is named; the faster of the two
   counts) at granite-3-2b's prefill shapes in the kernel's layout and at
   every prefill shape of those phases through ``attend``, each with its
   bound, the executed TFLOP/s of kernel and library, and the kernel's
   share of its bound.  At B 1, T 97 to 2000 and B 8, T 2048 a call of
   ``attend`` is split into the kernel's device time
   (``torch.profiler``), the host's time to issue it and its time on
   CUDA events; at B 8, T 2048 the bf16 output is held against float32
   references with P in float32 and with P rounded to bf16.
5. ``train``: ``repro_torch.launch.train`` at the full width of
   granite-3-2b (d_model 2048, 32 heads, 8 KV heads, d_ff 8192, vocab
   49155) and 4 of its 40 layers: 4 rounds with a snapshot every 2, a
   fresh ``--resume`` for 2 more, and an uninterrupted 6-round run whose
   losses must equal the first two's bit for bit; the newest snapshot must
   restore to the live state's exact bytes, and the kernel's launch
   counter must show the diff snapshot going through it.
6. ``serve``: granite-3-2b at full width and all 40 layers in bf16,
   (a) through ``repro_torch.launch.serve`` (8 requests of 1024 prompt
   tokens, 32 new tokens each, one batched prefill) and (b) through the
   continuous-batching ``ServingEngine`` (4 slots, 8 requests of 97 to
   2000 prompt tokens and 8 to 32 new tokens).  The flash-attention
   counter must read one launch per layer and prefill (40 and 320) and
   the scan's none, every logit must be finite, each engine request's
   first token must equal an isolated batch-1 prefill's, and one
   request's prefill and decode logits must match ``lm.forward_train``
   (the ``blocked_attention`` twin) over its prompt and generated tokens.
7. ``ssm_kernel``: ``ssm_scan`` against its plain PyTorch version on the
   card, y and the final state h, in f32 (2e-4) and bf16 (2e-2 for y), on
   ``tests/test_kernels.py``'s ``SSM_CASES`` (N 4 to 16, ragged T and
   Di), on the design's edges (N 1, 5, 24 and 32; T 1; Di no multiple of
   a block's channels; T whose last time chunk is one step, a chunk less
   one and a whole chunk; B 1, T 8192 at Di 3200, the long carry chain)
   and on every prefill shape of the serve_ssm phase; then timed with
   CUDA events beside the plain version, the bound and the special-
   function floor (the exponentials at 16 a clock per SM) at
   falcon-mamba-7b's Di 8192 and N 16 (B 1 and 8, T 512 to 2048) and at
   every prefill shape of the serve_ssm phase, each row with its launch
   plan (lanes per channel, time chunks, CUDA kernels a call) and, where
   it chunks, the time of the same call unchunked.
8. ``serve_ssm``: falcon-mamba-7b (d_model 4096, d_inner 8192, N 16,
   vocab 65024) at all 64 layers in bf16 through the launcher and the
   engine as in ``serve``, then hymba-1.5b (d_model 1600, 25 heads, 5 KV
   heads, d_inner 3200, N 16) at all 32 layers through the engine, with
   the same checks against isolated prefills and the twin
   (``forward_train``: the chunked associative scan).  The scan's counter
   must read 64 and 512 for falcon and 256 for hymba, and the attention
   kernel's none for falcon and 256 for hymba.
9. ``delta_ops``: the one-shot delta API's kernels (``changed_bitmap``,
   ``delta_encode``, ``delta_apply``) against their plain versions, bit
   for bit, on the ``kernel`` phase's leaves and patterns; a
   ``diff_blocks`` -> ``patch_blocks`` round trip that restores the exact
   bytes on ``tests/test_kernels.py``'s delta cases (NaN, Inf and signed
   zeros included) and on every kernel dtype with an odd 16-bit count;
   ``changed_blocks(fused=False)`` equal to ``fused=True``, as tiles and as
   store-chunk records.  Its main path: ``diff_blocks``, ``patch_blocks``
   and ``changed_blocks(fused=False)`` over float32 tensors of the
   training path's launch shapes (28, every tile changed, as AdamW leaves
   the state), one launch of each kernel per shape; then each kernel timed
   there beside its plain version, its bytes bound and, for
   ``delta_apply``, ``torch.bitwise_xor``, each of these two also by its
   device time alone (events around each call with the stream held busy
   ahead of them), shape by shape.
10. ``sprint``: the SPRINT correlation workload of the paper's Fig. 4 at
    its size, 11,000 genes x 321 samples (Load: made with numpy from seed
    0, moved to the card), Exec: two row-strip work units through the
    port's ``VolunteerScheduler`` on two volunteers, each strip from
    ``pcor_strip`` on the card and reported by a blake2b digest of its
    bytes, run twice with equal digests; then ``correlate`` on the full
    matrix.  The kernel's counter must read 5; the full matrix must be
    within 1e-5 of the plain version and 1e-4 of a float64 correlation,
    its diagonal within 1e-5 of 1, and the strips equal its rows bit for
    bit.  Then the kernel timed for the full matrix and per strip, beside
    the plain version, ``torch.corrcoef`` and two operations bounds: the
    kernel's route, 3xTF32 on the tensor cores (three TF32 products per
    FLOP of one triangle), whose share each row reports and which no row
    may beat, and float32 on the CUDA cores.

The last two run after the others, so that the multi-GB tensors they
leave in the allocator's cache cannot touch the train phase, and with
the train launcher's deterministic mode off: a standalone SPRINT or
delta user runs without it, and its fill of every new tensor would add
a pass over each output to the kernels' and plain versions' times.

Before and after each phase a ``clocks`` line gives the card's SM and
memory clocks, temperature, power draw and active throttle reasons
(``nvidia-smi``), so that a slow card is not read as a slow kernel.
Then a ``phase_seconds`` line (each phase's wall time), the ``kernels``
summary line (each of the seven kernels' launches on the main paths, with
its time, the plain version's, the library call's where there is one and
the bound summed over those launches) and,
last, ``{"ok": true, ...}``.  Any failed check exits
non-zero before that line.  Without a CUDA device it exits non-zero at
once.
"""
from __future__ import annotations

import os

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import time  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent
# H100 SXM, NVIDIA data sheet: device memory rate, dense peak operations
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bfloat16": 989e12, "float32": 67e12, "tf32": 495e12}
REPLACES = "src/repro/kernels/delta_encode/kernel.py:151"
SOURCE = "src/repro_torch/kernels/delta_encode/csrc/fused_delta.cu"
ATTN_REPLACES = "src/repro/kernels/flash_attention/kernel.py:78"
ATTN_SOURCE = "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu"
SSM_REPLACES = "src/repro/kernels/ssm_scan/kernel.py:57"
SSM_SOURCE = "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu"
# the one-shot delta API's kernels, each in SOURCE beside the probe
DELTA_REPLACES = {"changed_bitmap": "src/repro/kernels/delta_encode/kernel.py:78",
                  "delta_encode": "src/repro/kernels/delta_encode/kernel.py:54",
                  "delta_apply": "src/repro/kernels/delta_encode/kernel.py:197"}
# (tile outputs, bitmap outputs) each of them writes
DELTA_WRITES = {"changed_bitmap": (0, 1), "delta_encode": (1, 1),
                "delta_apply": (1, 0)}
PCOR_REPLACES = "src/repro/kernels/pcor/kernel.py:43"
PCOR_SOURCE = "src/repro_torch/kernels/pcor/csrc/pcor.cu"
# leaf sizes, in tiles, on which the delta kernels are checked bit for bit
CHECK_TILES = (1, 12320)
# the paper's Fig. 4 dataset and SPRINT layout
GENES, SAMPLES, WORKERS = 11_000, 321, 2

# (B, T, S, H, K, hd, causal): tests/test_kernels.py's ATTN_CASES, then
# the reduced configs' head size
ATTN_CASES = [
    (2, 256, 256, 4, 2, 64, True),
    (1, 128, 384, 8, 8, 32, False),
    (2, 200, 200, 6, 3, 64, True),
    (1, 96, 96, 4, 1, 128, False),
    (1, 64, 64, 2, 2, 256, True),
    (2, 37, 37, 4, 2, 16, True),
]
ATTN_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# the serve phase: (a) the launcher, one batched prefill; (b) the engine,
# one batch-1 prefill per request
LAUNCHER = {"requests": 8, "prompt_len": 1024, "gen": 32}
ENGINE_PROMPTS = (97, 250, 511, 777, 1024, 1333, 1700, 2000)
ENGINE_NEW = (8, 32, 16, 24, 12, 32, 20, 28)
ENGINE_SLOTS, ENGINE_MAX_LEN = 4, 2048 + 32
# granite-3-2b's prefill heads and falcon-mamba-7b's (Di, N), each kernel
# timed alone at B 1 and 8, T 512 to 2048
GRANITE_HEADS = (32, 8, 64)
SSM_TIMED_WIDTHS = (8192, 16)
TIMED_SHAPES = [(b, t) for b in (1, 8) for t in (512, 1024, 2048)]
PHASES = ("build", "kernel", "attn_kernel", "train", "serve", "ssm_kernel",
          "serve_ssm", "delta_ops", "sprint")
# (B, T, Di, N): tests/test_kernels.py's SSM_CASES
SSM_CASES = [(2, 64, 256, 16), (1, 50, 130, 8), (3, 32, 128, 16),
             (2, 128, 384, 4), (1, 33, 257, 16)]
# the scan design's edges: N not a power of two, N 1 and 32, T 1, Di no
# multiple of a block's channels (128 at one lane, 64 at two); the chunk
# boundaries come from chunk_edges
SSM_EDGE_CASES = [(2, 45, 100, 5), (1, 200, 300, 24), (2, 19, 70, 1),
                  (2, 45, 100, 32), (1, 1, 64, 16), (2, 1, 3200, 16),
                  (8, 64, 200, 16), (1, 333, 3201, 16)]
# the long carry chain, at hymba-1.5b's width
SSM_LONG = (1, 8192, 3200, 16)
SSM_TOL = {"float32": 2e-4, "bfloat16": 2e-2}
# special-function units: exponentials a clock per SM (H100)
SFU_PER_CLOCK = 16


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def granite_full_width(n_layers: int):
    from repro_torch.configs.base import get_arch, reduced
    return reduced(get_arch("granite-3-2b"), n_layers=n_layers, d_model=2048,
                   n_heads=32, n_kv_heads=8, d_ff=8192, vocab_size=49155)


# ---------------------------------------------------------------- gpu
def phase_gpu() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    line = out.stdout.strip().splitlines()[0]
    print(line, flush=True)
    emit({"gpu": line})
    return line


# the card's clocks, temperature, power draw and throttle reasons, printed
# before and after each phase
CLOCK_FIELDS = ("clocks.sm", "clocks.mem", "temperature.gpu", "power.draw",
                "clocks_throttle_reasons.active")


def clocks(phase: str, when: str) -> None:
    out = subprocess.run(["nvidia-smi", "--query-gpu=" + ",".join(
        CLOCK_FIELDS), "--format=csv,noheader"], capture_output=True,
        text=True, check=True, timeout=60)
    emit({"clocks": phase, "at": when,
          **dict(zip(CLOCK_FIELDS, (v.strip() for v in
                                    out.stdout.splitlines()[0].split(","))))})


def max_sm_clock_hz() -> float:
    """The SM clock the card can boost to (``clocks.max.sm``)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True,
                         timeout=60)
    return float(out.stdout.splitlines()[0]) * 1e6


# -------------------------------------------------------------- build
def phase_build() -> None:
    """One ``nvcc`` per kernel source, all started together."""
    from concurrent.futures import ThreadPoolExecutor

    from repro_torch.kernels.delta_encode import kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.pcor import kernel as pcor_kernel
    from repro_torch.kernels.ssm_scan import kernel as ssm_kernel
    mods = {"fused_delta_tiles": kernel, "flash_attention": fa_kernel,
            "ssm_scan": ssm_kernel, "pcor": pcor_kernel}
    with ThreadPoolExecutor(len(mods)) as pool:
        futs = {name: pool.submit(m.build, True) for name, m in mods.items()}
        secs = {name: f.result() for name, f in futs.items()}
    # every bf16 attention kernel and the correlation's tile-pair kernel
    # must run their products on the tensor cores
    hgmma = sass_count(fa_kernel._LIB_PATH, "HGMMA")
    pcor_hgmma = sass_count(pcor_kernel._LIB_PATH, "HGMMA")
    emit({"phase": "build", "seconds": secs, "hgmma": hgmma,
          "pcor_hgmma": pcor_hgmma, "ptxas": {
              name: [ln.strip() for ln in m.build_log().splitlines()
                     if "Used" in ln or "spill" in ln]
              for name, m in mods.items()}})
    wgmma = {fn: n for fn, n in hgmma.items() if "attn_fwd_wgmma" in fn}
    check(len(wgmma) > 0 and all(n > 0 for n in wgmma.values()),
          f"libflash_attention.so: HGMMA per wgmma kernel {wgmma}")
    pairs = {fn: n for fn, n in pcor_hgmma.items() if "corr_pairs" in fn}
    check(len(pairs) > 0 and all(n > 0 for n in pairs.values()),
          f"libpcor.so: HGMMA in the tile-pair kernel {pairs}")
    for name, m in (("ssm_scan", ssm_kernel), ("pcor", pcor_kernel)):
        spills = spilled(m.build_log())
        check(not spills, f"lib{name}.so: instantiations that spill {spills}")


def spilled(log: str) -> list:
    """The functions of a ``-Xptxas=-v`` log whose spill stores or loads
    are not 0 bytes."""
    out, fn = [], None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            fn = line.split("'")[1] if "'" in line else line
        elif "spill stores" in line:
            stores, loads = re.findall(r"(\d+) bytes spill", line)
            if int(stores) or int(loads):
                out.append(fn)
    return out


def sass_count(lib: Path, opcode: str) -> dict:
    """Instructions of ``opcode`` in each function of ``cuobjdump -sass``
    of ``lib``, by mangled function name."""
    tool = shutil.which("cuobjdump") or str(
        Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin"
        / "cuobjdump")
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, check=True, timeout=300).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and opcode in line:
            counts[fn] += 1
    return counts


# ------------------------------------------------------------- kernel
def _mutated(old, pattern: str, gen):
    """Copy of ``old`` with one bit flipped in each selected tile."""
    import torch

    from repro_torch.kernels.delta_encode.kernel import TILE
    new = old.clone()
    bits = new.view(torch.int16 if old.element_size() == 2 else torch.int32)
    per_tile = TILE * 4 // old.element_size()
    n = old.numel()
    ntiles = -(-n // per_tile)
    if pattern == "none":
        return new
    if pattern == "all":
        tiles = torch.arange(ntiles, device=old.device)
    elif pattern == "first_last":
        idx = torch.tensor([0, n - 1], device=old.device)
        bits[idx] ^= 16
        return new
    else:                                           # random 10 %
        tiles = torch.randperm(ntiles, generator=gen,
                               device=old.device)[:max(1, ntiles // 10)]
    offs = torch.randint(0, per_tile, (tiles.numel(),), generator=gen,
                         device=old.device)
    idx = torch.clamp(tiles * per_tile + offs, max=n - 1)
    bits[idx] ^= 16
    return new


def _leaf(dtype, numel: int, gen):
    import torch
    if dtype.is_floating_point:
        return torch.randn(numel, dtype=dtype, device="cuda", generator=gen)
    info = torch.iinfo(dtype)
    return torch.randint(info.min, info.max, (numel,), dtype=dtype,
                         device="cuda", generator=gen)


def _time_ms(fn, reps: int) -> float:
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _device_ms(fn, n: int = 5) -> float:
    """Device time per call of ``fn``: CUDA events just before and after
    each call, with the stream held busy (``torch.cuda._sleep``) until all
    n calls are queued, so that no host time falls between two events.
    (``torch.profiler`` loses kernels once earlier sessions ran in the
    process, as the serve phases' traces do.)"""
    import torch
    fn()
    torch.cuda.synchronize()
    marks = [[torch.cuda.Event(enable_timing=True) for _ in range(2)]
             for _ in range(n)]
    torch.cuda._sleep(20_000_000)           # about 10 ms at 2 GHz
    for start, end in marks:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in marks) / n


def path_launches(cfg) -> list:
    """Tile counts of the fused launches one diff snapshot of this
    config's train state issues (``ops.plan_buckets`` on the state)."""
    import numpy as np

    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.models import api
    metas = {}
    for key, spec in tu.flatten_with_keys(api.state_specs(cfg)):
        itemsize = spec.dtype.itemsize
        nbytes = int(np.prod(spec.shape, dtype=np.int64)) * itemsize
        n_i32 = -(-nbytes // 4)
        metas[key] = (nbytes, -(-n_i32 // (ops.TILE_BYTES // 4)),
                      ops.dtype_name(spec.dtype))
    out = []
    for bid, leaves in ops.plan_buckets(metas):
        if bid < 0:
            out.extend(nt for _, _, nt, _ in leaves)
        else:
            out.append(sum(nt for _, _, nt, _ in leaves))
    return out


def phase_kernel(cfg, reps: int = 5) -> dict:
    import torch

    from repro_torch.kernels.delta_encode.kernel import (
        TILE, as_i32_tiles, fused_delta_tiles)
    from repro_torch.kernels.delta_encode.ops import (KERNEL_DTYPES,
                                                      TILE_BYTES,
                                                      dtype_from_name)
    from repro_torch.kernels.delta_encode.ref import fused_tiles_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    cases, max_err = 0, 0
    for name in KERNEL_DTYPES:
        dtype = dtype_from_name(name)
        per_tile = TILE * 4 // dtype.itemsize
        for ntiles in CHECK_TILES:
            numel = (ntiles - 1) * per_tile + per_tile // 2 + 3   # ragged
            old = _leaf(dtype, numel, gen)
            o32, _ = as_i32_tiles(old)
            check(o32.shape[0] == ntiles, f"tile count {o32.shape[0]}")
            for pattern in ("none", "all", "first_last", "random10"):
                new = _mutated(old, pattern, gen)
                n32, _ = as_i32_tiles(new)
                bm, tiles = fused_delta_tiles(o32, n32)
                bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
                torch.cuda.synchronize()
                k = int(bm_ref.sum())
                err = max(int((bm.long() - bm_ref.long()).abs().max()),
                          int((tiles[:k].long() - tiles_ref.long())
                              .abs().max()) if k else 0)
                max_err = max(max_err, err)
                check(torch.equal(bm, bm_ref)
                      and torch.equal(tiles[:k], tiles_ref),
                      f"kernel != plain: {name} {ntiles} tiles {pattern}")
                cases += 1
                del new, n32, bm, tiles, bm_ref, tiles_ref
            del old, o32
    torch.cuda.empty_cache()

    # times at the training path's launch shapes, every tile changed (as
    # AdamW leaves the state), each distinct shape timed once
    launches = path_launches(cfg)
    ms = plain_ms = 0.0
    moved = 0
    shape_ms = {}

    def timed(o32, n32):
        """Check one pair against the plain version; -> (kernel ms, plain
        ms, bytes the function moves: inputs read once, the bitmap and
        the k changed tiles written once)."""
        bm, tiles = fused_delta_tiles(o32, n32)
        bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
        k = int(bm_ref.sum())
        check(torch.equal(bm, bm_ref) and torch.equal(tiles[:k], tiles_ref),
              f"kernel != plain at the path's shape of {o32.shape[0]} tiles")
        del bm, tiles, bm_ref, tiles_ref
        nblk = o32.shape[0]
        return (_time_ms(lambda: fused_delta_tiles(o32, n32), reps),
                _time_ms(lambda: fused_tiles_ref(o32, n32), reps),
                (2 * nblk + k) * TILE_BYTES + 4 * nblk)

    for nblk in sorted(set(launches)):
        count = launches.count(nblk)
        o32 = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                            dtype=torch.int32, device="cuda", generator=gen)
        n32 = o32 ^ 1
        k_ms, p_ms, nbytes = timed(o32, n32)
        cases += 1
        shape_ms[nblk] = k_ms
        ms += count * k_ms
        plain_ms += count * p_ms
        moved += count * nbytes
        del o32, n32
    torch.cuda.empty_cache()
    bound_ms = moved / HBM_BYTES_PER_S * 1e3

    # the largest launch again with a random 10 % of its tiles changed
    # (a probe between two rounds that left most tiles alone)
    nblk = max(launches)
    o32 = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                        dtype=torch.int32, device="cuda", generator=gen)
    n32 = o32.clone()
    picked = torch.randperm(nblk, generator=gen, device="cuda")[:nblk // 10]
    n32[picked, 0, 0] ^= 1
    k_ms, p_ms, nbytes = timed(o32, n32)
    cases += 1
    random10 = {"tiles": nblk, "changed": int(picked.numel()), "ms": k_ms,
                "plain_ms": p_ms, "bytes": nbytes,
                "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                "all_changed_ms": shape_ms[nblk],
                "all_changed_bytes": (3 * nblk) * TILE_BYTES + 4 * nblk}
    del o32, n32, picked
    torch.cuda.empty_cache()
    res = {"phase": "kernel", "name": "fused_delta_tiles", "cases": cases,
           "tolerance": "bit for bit", "max_abs_err": max_err, "launches_per_snapshot": len(launches),
           "snapshot_tiles": sum(launches), "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": "bytes", "bytes": moved,
           "random10": random10, "reps": reps}
    emit(res)
    return res


# ---------------------------------------------------------- delta_ops
def _delta_kernels() -> dict:
    """The one-shot delta API's kernel wrappers and their plain versions,
    by name."""
    from repro_torch.kernels.delta_encode import kernel, ref
    return {"changed_bitmap": (kernel.changed_bitmap,
                               ref.changed_bitmap_ref),
            "delta_encode": (kernel.delta_encode, ref.delta_encode_ref),
            "delta_apply": (kernel.delta_apply, ref.delta_apply_ref)}


def _int_err(a, b) -> int:
    """Largest |a - b| of two integer tensors of one shape (0 if equal)."""
    import torch
    check(a.shape == b.shape, f"shapes {tuple(a.shape)} != {tuple(b.shape)}")
    return 0 if torch.equal(a, b) else int((a.long() - b.long()).abs().max())


def _roundtrip_cases(gen) -> list:
    """(name, old, new) on the card: ``tests/test_kernels.py``'s delta
    cases, its NaN/Inf/signed-zero case, an unchanged tensor, and every
    kernel dtype with an odd 16-bit count."""
    import numpy as np
    import torch

    from repro_torch.kernels.delta_encode.ops import (KERNEL_DTYPES,
                                                      dtype_from_name)
    rng = np.random.default_rng(0)
    cases = []
    for dtype, shape in ((np.float32, (1000, 517)), (np.float32, (8192,)),
                         (np.int32, (3, 8193)), (np.float32, (7,))):
        if dtype == np.float32:
            old = rng.standard_normal(shape).astype(dtype)
        else:
            old = rng.integers(-2 ** 30, 2 ** 30, shape).astype(dtype)
        new = old.copy()
        flat = new.reshape(-1)
        idx = rng.choice(flat.size, size=max(1, flat.size // 50),
                         replace=False)
        flat[idx] = flat[idx] * 2 + 1
        cases.append((f"{dtype.__name__}{shape}", old, new))
    old = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0] * 2000, np.float32)
    new = old.copy()
    new[::7] = 1.5
    new[3::11] = -0.0
    cases += [("nan_inf_signed_zero", old, new),
              ("unchanged", np.ones(30_000, np.float32),
               np.ones(30_000, np.float32))]
    cases = [(n, torch.from_numpy(o).cuda(), torch.from_numpy(w).cuda())
             for n, o, w in cases]
    for name in KERNEL_DTYPES:
        old = _leaf(dtype_from_name(name), 2 * 8192 + 777, gen)
        cases.append((f"{name}_odd", old, _mutated(old, "random10", gen)))
    old = torch.randn(9001, dtype=torch.float64, device="cuda",
                      generator=gen)
    new = old.clone()
    new[[0, 4000, 9000]] += 3.0
    return cases + [("float64_byte_view", old, new)]


def _bytes_equal(a, b) -> bool:
    import torch
    return a.shape == b.shape and a.dtype == b.dtype and torch.equal(
        a.reshape(-1).view(torch.uint8), b.reshape(-1).view(torch.uint8))


def phase_delta_ops(cfg, reps: int = 5) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import TILE, as_i32_tiles
    gen = torch.Generator(device="cuda").manual_seed(1)
    kernels = _delta_kernels()
    (bitmap_k, bitmap_ref), (encode_k, encode_ref), (apply_k, apply_ref) = \
        kernels.values()
    max_err = dict.fromkeys(kernels, 0)
    cases = 0
    # (a) each kernel against its plain version, bit for bit
    for name in ops.KERNEL_DTYPES:
        dtype = ops.dtype_from_name(name)
        per_tile = TILE * 4 // dtype.itemsize
        for ntiles in CHECK_TILES:
            numel = (ntiles - 1) * per_tile + per_tile // 2 + 3   # ragged
            old = _leaf(dtype, numel, gen)
            o32, _ = as_i32_tiles(old)
            for pattern in ("none", "all", "first_last", "random10"):
                n32, _ = as_i32_tiles(_mutated(old, pattern, gen))
                bm = bitmap_k(o32, n32)
                delta, bm2 = encode_k(o32, n32)
                back = apply_k(o32, delta)
                want_delta, want_bm = encode_ref(o32, n32)
                errs = {"changed_bitmap": max(
                            _int_err(bm, bitmap_ref(o32, n32)),
                            _int_err(bm, want_bm)),
                        "delta_encode": max(_int_err(delta, want_delta),
                                            _int_err(bm2, want_bm)),
                        "delta_apply": max(
                            _int_err(back, apply_ref(o32, want_delta)),
                            _int_err(back, n32))}
                for k, e in errs.items():
                    max_err[k] = max(max_err[k], e)
                    check(e == 0, f"{k} != plain: {name} {ntiles} tiles "
                          f"{pattern} (err {e})")
                cases += 1
                del n32, bm, delta, bm2, back, want_delta, want_bm
            del old, o32
    torch.cuda.empty_cache()

    # (b) diff -> patch restores the exact bytes; (c) changed_blocks'
    # two routes agree, as tiles and as store-chunk records
    for name, old, new in _roundtrip_cases(gen):
        tiles, bitmap, _ = ops.diff_blocks(old, new)
        check(_bytes_equal(ops.patch_blocks(old, tiles, bitmap), new),
              f"diff_blocks -> patch_blocks did not restore {name}")
        routes = [ops.changed_blocks(old, new, fused=f) for f in (True,
                                                                   False)]
        records = [ops.changed_blocks(old, new, fused=f, emit="records",
                                      chunk_bytes=1 << 14)
                   for f in (True, False)]
        check(all(np.array_equal(t, tiles) and np.array_equal(b, bitmap)
                  for t, b, _ in routes),
              f"changed_blocks tiles differ from diff_blocks: {name}")
        check(records[0][0] == records[1][0] and np.array_equal(
            records[0][1], records[1][1]) and np.array_equal(
            records[0][1], new.reshape(-1).view(torch.uint8).cpu().numpy()),
              f"changed_blocks records: fused != unfused: {name}")
        cases += 1
    torch.cuda.empty_cache()

    # the main path: the one-shot API over the training path's launch
    # shapes, every count set to 0 just before and read just after
    launches = path_launches(cfg)

    def state_pair(nblk):
        bits = torch.randint(-2**31, 2**31 - 1, (nblk * TILE,),
                             dtype=torch.int32, device="cuda", generator=gen)
        return bits.view(torch.float32), (bits ^ 1).view(torch.float32)

    def drive():
        for nblk in launches:
            old, new = state_pair(nblk)
            tiles, bitmap, _ = ops.diff_blocks(old, new)
            check(bool(bitmap.all()), f"diff_blocks missed a tile of {nblk}")
            check(_bytes_equal(ops.patch_blocks(old, tiles, bitmap), new),
                  f"patch_blocks did not restore {nblk} tiles")
            t2, b2, _ = ops.changed_blocks(old, new, fused=False)
            check(np.array_equal(t2, tiles) and np.array_equal(b2, bitmap),
                  f"changed_blocks(fused=False) != diff_blocks at {nblk}")
            del old, new, tiles, t2
    t0 = time.perf_counter()
    _, counts = _launched({k: fn for k, (fn, _) in kernels.items()}, drive)
    drive_s = time.perf_counter() - t0
    check(counts == dict.fromkeys(kernels, len(launches)),
          f"delta_ops launches {counts}, expected {len(launches)} each")
    torch.cuda.empty_cache()

    # times at those shapes, each distinct shape timed once
    rows = {k: [] for k in kernels}
    apply_rows = []
    for nblk in sorted(set(launches)):
        count = launches.count(nblk)
        o32 = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                            dtype=torch.int32, device="cuda", generator=gen)
        n32 = o32 ^ 1
        d32 = o32 ^ n32
        tile_bytes = nblk * 4 * TILE
        for name, (fn, plain) in kernels.items():
            b = d32 if name == "delta_apply" else n32
            # two inputs read once, the outputs written once
            tiles_out, bitmap_out = DELTA_WRITES[name]
            moved = (2 + tiles_out) * tile_bytes + bitmap_out * 4 * nblk
            row = {"ms": _time_ms(lambda: fn(o32, b), reps),
                   "plain_ms": _time_ms(lambda: plain(o32, b), reps),
                   "ops": 0, "bytes": moved,
                   "bound_ms": moved / HBM_BYTES_PER_S * 1e3}
            if name == "delta_apply":
                # the call's time on events beside its kernel's device time
                # (no host time between its events), and the same for the
                # library call
                xor = lambda: torch.bitwise_xor(o32, d32)  # noqa: E731
                row.update({"library_ms": _time_ms(xor, reps),
                            "device_ms": _device_ms(lambda: fn(o32, b)),
                            "library_device_ms": _device_ms(xor)})
                apply_rows.append({"tiles": nblk, "launches": count,
                                   **row})
            rows[name].append((row, count))
        del o32, n32, d32
    torch.cuda.empty_cache()
    paths = {k: _sum_path(r, "float32") for k, r in rows.items()}
    for k, path in paths.items():
        path.setdefault("library_ms", None)
    res = {"phase": "delta_ops", "cases": cases, "tolerance": "bit for bit",
           "max_abs_err": max_err, "main_path_s": drive_s,
           "launches": counts, "state_tiles": sum(launches), "reps": reps,
           "paths": paths, "delta_apply_shapes": apply_rows}
    emit(res)
    return res


# -------------------------------------------------------------- sprint
def _sprint_exec(x, workers: int = WORKERS) -> tuple:
    """``benchmarks/fig4_sprint_pcor.py``'s ``_exec_workunits`` where ``x``
    lies (``tests/test_torch_pcor.py`` runs it on the CPU): row-strip units
    through the scheduler on ``workers`` volunteers, each strip copied into
    the host matrix and reported by the blake2b digest of its bytes.
    -> (host matrix, strips by row start, digests by unit, seconds)."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core.scheduler import SimClock, VolunteerScheduler
    from repro_torch.kernels.pcor.ops import pcor_strip
    g = x.shape[0]
    if x.is_cuda:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    sched = VolunteerScheduler(clock=SimClock())
    strip = (g + workers - 1) // workers
    for i in range(workers):
        sched.submit(i, {"row_start": i * strip})
    out = np.empty((g, g), np.float32)
    strips, digests = {}, {}
    for w in range(workers):
        wid = f"sprint-{w}"
        sched.join(wid)
        unit = sched.request_work(wid)
        r0 = unit.payload["row_start"]
        rc = min(strip, g - r0)
        strips[r0] = pcor_strip(x, r0, rc)
        torch.from_numpy(out[r0:r0 + rc]).copy_(strips[r0])
        digests[unit.unit_id] = hashlib.blake2b(
            memoryview(out[r0:r0 + rc]).cast("B")).hexdigest()
        check(sched.report(wid, unit.unit_id, digests[unit.unit_id]),
              f"report of unit {unit.unit_id} refused")
    check(sched.done(), "the scheduler is not done after every report")
    check(sched.canonical_results() == digests,
          "the scheduler's canonical results != the reported digests")
    return out, strips, digests, time.perf_counter() - t0


def pcor_work(rows: int, g: int, s: int) -> dict:
    """Operations and bytes of ``rows`` rows of the correlation of a (g, s)
    float32 matrix, and its bounds: x read once and the rows written once,
    against the FLOP on the route the kernel takes, 3xTF32 on the tensor
    cores (three TF32 products per FLOP, ``ops``), and, beside it, in
    float32 on the CUDA cores (``fp32_bound_ms``).  The matrix is
    symmetric, so the strip's own (rows, rows) diagonal block needs only
    its upper triangle, rows (rows + 1) s FLOP, beside 2 s rows (g - rows)
    for the rest; the full matrix needs g (g + 1) s."""
    flop = 2 * s * rows * (g - rows) + s * rows * (rows + 1)
    nbytes = 4 * (g * s + rows * g)
    tc_ms = 3 * flop / PEAK_OPS_PER_S["tf32"] * 1e3
    fp32_ms = flop / PEAK_OPS_PER_S["float32"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"flop": flop, "ops": 3 * flop, "bytes": nbytes,
            "bound_ms": max(tc_ms, bytes_ms),
            "bound_by": "operations" if tc_ms >= bytes_ms else "bytes",
            "fp32_bound_ms": max(fp32_ms, bytes_ms)}


def phase_sprint(reps: int = 5) -> dict:
    import numpy as np
    import torch

    from repro_torch.kernels.pcor.kernel import pcor
    from repro_torch.kernels.pcor.ops import correlate
    from repro_torch.kernels.pcor.ref import pcor_ref, pcor_rows_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (GENES, SAMPLES)).astype(np.float32)).cuda()
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0

    # the main path: two Exec runs and the full matrix
    def drive():
        runs = [_sprint_exec(x) for _ in range(2)]
        full = correlate(x)
        torch.cuda.synchronize()
        return runs, full
    (runs, full), counts = _launched({"pcor": pcor}, drive)
    (host, strips, digests, exec_s), (_, _, digests2, exec2_s) = runs
    expected = 2 * WORKERS + 1
    check(counts["pcor"] == expected,
          f"pcor launched {counts['pcor']} times, expected {expected}")
    check(digests == digests2, f"digests differ between runs: {digests} "
          f"{digests2}")

    # the checks
    want = pcor_ref(x)
    err = float((full - want).abs().max())
    check(torch.allclose(full, want, rtol=1e-5, atol=1e-5),
          f"pcor != plain: max abs err {err}")
    x64 = x.double()
    xc = x64 - x64.mean(dim=1, keepdim=True)
    z64 = xc / xc.norm(dim=1, keepdim=True)
    ref64 = z64 @ z64.T
    err64 = float((full.double() - ref64).abs().max())
    check(torch.allclose(full.double(), ref64, rtol=1e-4, atol=1e-4),
          f"pcor vs float64 correlation: max abs err {err64}")
    del x64, xc, z64, ref64
    diag_err = float((full.diagonal() - 1.0).abs().max())
    check(diag_err <= 1e-5, f"diagonal off 1 by {diag_err}")
    strip_err = 0.0
    for r0, st in strips.items():
        check(torch.equal(st, full[r0:r0 + st.shape[0]]),
              f"strip at row {r0} != the full matrix's rows")
        plain = pcor_rows_ref(x, r0, st.shape[0])
        strip_err = max(strip_err, float((st - plain).abs().max()))
        check(torch.allclose(st, plain, rtol=1e-5, atol=1e-5),
              f"strip at row {r0} != plain: max abs err {strip_err}")
        del plain
    check(np.array_equal(host, full.cpu().numpy()),
          "the assembled host matrix != the full matrix")
    del want, host
    torch.cuda.empty_cache()

    # the times: the full matrix and each strip
    def timed(r0, rc):
        row = {"rows": [r0, r0 + rc],
               "ms": _time_ms(lambda: pcor(x, row_start=r0, row_count=rc),
                              reps),
               "plain_ms": _time_ms(lambda: pcor_rows_ref(x, r0, rc),
                                    reps)}
        row.update(pcor_work(rc, GENES, SAMPLES))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        torch.cuda.empty_cache()
        return row
    full_row = timed(0, GENES)
    full_row["library_ms"] = _time_ms(lambda: torch.corrcoef(x), reps)
    strip_rows = [timed(r0, st.shape[0]) for r0, st in strips.items()]
    # each Exec run launches every strip once, then the full matrix once;
    # the library computes one run's strips (the whole matrix) in one call
    path = _sum_path([(r, 2) for r in strip_rows] + [(full_row, 1)], "tf32")
    path["library_ms"] = 3 * full_row["library_ms"]
    path["bound_share"] = path["bound_ms"] / path["ms"]
    for row in (full_row, *strip_rows, path):
        check(row["bound_share"] <= 1.0,
              f"pcor faster than its bound: {row}")
    res = {"phase": "sprint", "genes": GENES, "samples": SAMPLES,
           "workers": WORKERS, "load_s": load_s, "exec_s": [exec_s, exec2_s],
           "digests": digests, "launches": counts["pcor"],
           "max_abs_err": {"plain": err, "float64": err64,
                           "diagonal": diag_err, "strips_plain": strip_err},
           "tolerance": {"plain": 1e-5, "float64": 1e-4, "diagonal": 1e-5,
                         "strips_vs_full": "bit for bit"},
           "reps": reps, "full": full_row, "strips": strip_rows,
           "path": path}
    emit(res)
    return res


# -------------------------------------------------------- attn_kernel
def attn_work(b: int, t: int, s: int, h: int, kh: int, hd: int,
              causal: bool, dtype: str) -> dict:
    """Operations and bytes one flash-attention call needs, and its bound:
    the larger of the operations at the card's peak for the dtype and the
    bytes (q, k, v read once, o written once) at its memory rate."""
    pairs = sum(min(i + 1, s) for i in range(t)) if causal else t * s
    ops = 4 * b * h * hd * pairs             # QK^T and PV, 2 each per pair
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * hd * (2 * b * h * t + 2 * b * kh * s)
    ops_ms = ops / PEAK_OPS_PER_S[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "bytes": nbytes, "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _attn_inputs(b, t, s, h, kh, hd, dtype, gen, model: bool = False):
    """q, k, v in the kernel's layout, (B, H, T, hd) and (B, K, S, hd), or
    with ``model`` in the model's, (B, T, H, hd) and (B, S, K, hd)."""
    import torch
    shapes = (((b, t, h, hd), (b, s, kh, hd)) if model
              else ((b, h, t, hd), (b, kh, s, hd)))
    return tuple(torch.randn(shape, device="cuda", generator=gen)
                 .to(getattr(torch, dtype))
                 for shape in (shapes[0], shapes[1], shapes[1]))


def _heads_first(*xs) -> tuple:
    """(B, T, H, hd) tensors as the (B, H, T, hd) views the kernel reads."""
    return tuple(x.transpose(1, 2) for x in xs)


def prefill_calls(launcher: bool) -> list:
    """(B, T, prefill calls) of one configuration's serve drive: the
    launcher's one batched prefill (where it runs), then the engine's
    batch-1 prefills."""
    out = [(LAUNCHER["requests"], LAUNCHER["prompt_len"], 1)] \
        if launcher else []
    return out + [(1, t, ENGINE_PROMPTS.count(t))
                  for t in sorted(set(ENGINE_PROMPTS))]


def heads(cfg) -> tuple:
    return cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim


def _sum_path(rows: list, dtype: str) -> dict:
    """Sum (row, launches) pairs into one path total; the bound's term is
    the larger of the summed operations and bytes."""
    path = {"launches": 0}
    keys = [k for k in ("ms", "plain_ms", "library_ms", "sdpa_flash_ms",
                        "sdpa_default_ms", "device_ms", "library_device_ms",
                        "bound_ms", "sfu_floor_ms", "fp32_bound_ms", "flop",
                        "ops", "bytes")
            if k in rows[0][0]]
    for key in keys:
        path[key] = 0.0
    for row, n in rows:
        path["launches"] += n
        for key in keys:
            path[key] += n * row[key]
    ops_ms = path["ops"] / PEAK_OPS_PER_S[dtype] * 1e3
    path["bound_by"] = ("operations" if ops_ms >= path["bytes"]
                        / HBM_BYTES_PER_S * 1e3 else "bytes")
    return path


# the library yardsticks: SDPA pinned to its flash backend (never the
# math route; a refusal fails the phase) and SDPA under its default
# dispatch, whose backend is named; ``library_ms`` is the faster of the two
SDPA_FLASH = "FLASH_ATTENTION"
# (B, T) at granite-3-2b's heads in the model's layout, where the kernel's
# device time is split from the wrapper's host time per call
SPLIT_SHAPES = ((1, 97), (1, 250), (1, 512), (1, 777), (1, 2000),
                (8, 2048))


def _sdpa(q, k, v):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                          enable_gqa=True)


def _time_sdpa(q, k, v, reps: int) -> dict:
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([getattr(SDPBackend, SDPA_FLASH)]):
        flash = _time_ms(lambda: _sdpa(q, k, v), reps)
    default = _time_ms(lambda: _sdpa(q, k, v), reps)
    picked = SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=True, enable_gqa=True)).name
    return {"sdpa_flash_ms": flash, "sdpa_default_ms": default,
            "sdpa_default_backend": picked,
            "library_ms": min(flash, default)}


def _rates(row: dict) -> dict:
    """Executed TFLOP/s of the kernel and the library call, and the
    kernel's share of its bound."""
    return {"tflops": row["ops"] / row["ms"] / 1e9,
            "library_tflops": row["ops"] / row["library_ms"] / 1e9,
            "bound_share": row["bound_ms"] / row["ms"]}


def _split(fn, n: int = 20) -> dict:
    """One call of ``fn`` taken apart: the attention kernel's device time
    per launch (``torch.profiler``), the host's time to issue the call
    (no sync between calls) and the call's time on CUDA events; the
    kernel's name says which instantiation ran."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    # a profiler session now and then loses a launch's record: the time
    # comes from the first of three sessions that saw every launch, else
    # the phase fails
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        ran = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and "attn_fwd" in e.key]
        if sum(e.count for e in ran) == n:
            break
    check(sum(e.count for e in ran) == n,
          f"profiler saw {[(e.key, e.count) for e in ran]} for {n} calls")
    return {"kernel_us": sum(e.self_device_time_total for e in ran) / n,
            "host_us": host_us, "call_us": _time_ms(fn, n) * 1e3,
            "kernel": [e.key[e.key.index("attn_fwd"):].split("(")[0]
                       for e in ran]}


def _attention_bf16_p(q, k, v):
    """``attention_ref`` with P rounded to bf16 before P.V, as the
    kernel's bf16 route multiplies it; float32 out."""
    import torch
    b, h, t, hd = q.shape
    rep = h // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1).float()
    v = torch.repeat_interleave(v, rep, dim=1).float()
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k) / math.sqrt(hd)
    mask = torch.ones(t, k.shape[2], dtype=torch.bool,
                      device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    del s
    return torch.einsum("bhts,bhsd->bhtd", p.bfloat16().float(), v)


def _p_rounding(gen) -> dict:
    """The bf16 route's error at granite's B 8, T 2048, causal, against
    float32 references (no rounding of the output) with P in float32, as
    the TPU kernel keeps it, and with P rounded to bf16, as this kernel
    does."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ref import attention_ref
    b, t, (h, kh, hd) = 8, 2048, GRANITE_HEADS
    q, k, v = _attn_inputs(b, t, t, h, kh, hd, "bfloat16", gen)
    out = flash_attention(q, k, v, causal=True).float()
    f32_p = attention_ref(q.float(), k.float(), v.float(), causal=True)
    bf16_p = _attention_bf16_p(q, k, v)
    res = {"B": b, "T": t, "vs_f32_p": float((out - f32_p).abs().max()),
           "vs_bf16_p": float((out - bf16_p).abs().max()),
           "bf16_p_vs_f32_p": float((bf16_p - f32_p).abs().max())}
    del q, k, v, out, f32_p, bf16_p
    torch.cuda.empty_cache()
    return res


def phase_attn_kernel(paths: dict, reps: int = 5) -> dict:
    """``paths``: {name: (cfg, launcher)} of the serve drives whose
    prefills launch the kernel."""
    import torch

    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.flash_attention.ops import attend
    from repro_torch.kernels.flash_attention.ref import attention_ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(0)
    # (case, dtype, model layout): every path shape both in the kernel's
    # layout and in the model's, as the path hands it over through attend
    checks = [(case, dtype, False) for case in ATTN_CASES
              for dtype in ("float32", "bfloat16")]
    for cfg, launcher in paths.values():
        checks += [((b, t, t, *heads(cfg), True), "bfloat16", model)
                   for b, t, _ in prefill_calls(launcher)
                   for model in (False, True)]
    max_err = {"float32": 0.0, "bfloat16": 0.0}
    for (b, t, s, nh, nkh, d, causal), dtype, model in checks:
        q, k, v = _attn_inputs(b, t, s, nh, nkh, d, dtype, gen, model)
        if model:
            out = attend(q, k, v, causal=causal).transpose(1, 2)
            q, k, v = _heads_first(q, k, v)
        else:
            out = flash_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = float((out.float() - want.float()).abs().max())
        max_err[dtype] = max(max_err[dtype], err)
        tol = ATTN_TOL[dtype]
        check(torch.allclose(out.float(), want.float(), rtol=tol, atol=tol),
              f"flash_attention != plain: {(b, t, s, nh, nkh, d, causal)} "
              f"{dtype}{' through attend' if model else ''}, max abs err "
              f"{err}")
        del q, k, v, out, want
    torch.cuda.empty_cache()

    def timed(b, t, hs, model=False):
        """The kernel's time at one shape, in the kernel's layout or, with
        ``model``, through ``attend`` in the model's (the serving path's
        call); the plain version and SDPA on the same views."""
        h, kh, hd = hs
        q, k, v = _attn_inputs(b, t, t, h, kh, hd, "bfloat16", gen, model)
        if model:
            ms = _time_ms(lambda: attend(q, k, v), reps)
            q, k, v = _heads_first(q, k, v)
        else:
            ms = _time_ms(lambda: flash_attention(q, k, v), reps)
        row = {"B": b, "T": t, "ms": ms, "plain_ms": _time_ms(
            lambda: attention_ref(q, k, v, causal=True), reps)}
        row.update(_time_sdpa(q, k, v, reps))
        row.update(attn_work(b, t, t, h, kh, hd, True, "bfloat16"))
        row.update(_rates(row))
        del q, k, v
        torch.cuda.empty_cache()
        return row

    def split(b, t):
        q, k, v = _attn_inputs(b, t, t, *GRANITE_HEADS, "bfloat16", gen,
                               True)
        row = {"B": b, "T": t, **_split(lambda: attend(q, k, v))}
        del q, k, v
        return row

    res = {"phase": "attn_kernel", "name": "flash_attention",
           "cases": len(checks), "tolerance": ATTN_TOL,
           "max_abs_err": max_err, "reps": reps,
           "library": f"scaled_dot_product_attention, the faster of "
                      f"{SDPA_FLASH} and the default dispatch",
           "shapes": [timed(b, t, GRANITE_HEADS) for b, t in TIMED_SHAPES],
           "split": [split(b, t) for b, t in SPLIT_SHAPES],
           "p_rounding": _p_rounding(gen)}
    # each serve drive's main path, as it runs: attend on the model's
    # layout, n_layers launches per prefill call
    rows = {name: [(timed(b, t, heads(cfg), True), calls * cfg.n_layers)
                   for b, t, calls in prefill_calls(launcher)]
            for name, (cfg, launcher) in paths.items()}
    res["paths"] = {name: _sum_path(r, "bfloat16")
                    for name, r in rows.items()}
    res["path"] = _sum_path([x for r in rows.values() for x in r],
                            "bfloat16")
    for path in (*res["paths"].values(), res["path"]):
        path.update(_rates(path))
    emit(res)
    return res


# ----------------------------------------------------------- ssm_kernel
def ssm_work(b: int, t: int, di: int, n: int, dtype: str) -> dict:
    """Operations and bytes one selective-scan call needs, and its bound.
    Bytes: x and dt read and y written in ``dtype``, bm, cm and a read and
    the final h written in f32, each once.  Operations: per state element
    and step dt*a, exp(.)*h, (dt x)*b, +, c*h and the sum over N (6), per
    channel and step dt*x (1), all f32; the exponentials are counted
    apart (``exps``), on the special-function units."""
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * 3 * b * t * di + 4 * (2 * b * t * n + di * n
                                           + b * di * n)
    ops = 6 * b * t * di * n + b * t * di
    ops_ms = ops / PEAK_OPS_PER_S["float32"] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return {"ops": ops, "exps": b * t * di * n, "bytes": nbytes,
            "bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes"}


def _ssm_inputs(b, t, di, n, dtype, gen, model_a: bool = False):
    """``tests/test_kernels.py``'s distribution: dt small and positive,
    a < 0; x and dt in ``dtype``, bm, cm and a in f32.  ``model_a``: a as
    the SSM block initialises it instead, -exp(log(1..N)) on every
    channel."""
    import torch
    dt_ = getattr(torch, dtype)
    x = torch.randn((b, t, di), device="cuda", generator=gen).to(dt_)
    dt = (0.1 * torch.randn((b, t, di), device="cuda", generator=gen)
          .abs()).to(dt_)
    bm, cm = (torch.randn((b, t, n), device="cuda", generator=gen)
              for _ in range(2))
    a = -torch.randn((di, n), device="cuda", generator=gen).abs()
    if model_a:
        a = -torch.arange(1, n + 1, device="cuda",
                          dtype=torch.float32).expand(di, n).contiguous()
    return x, dt, bm, cm, a


def chunk_edges(di: int, n: int, sms: int) -> list:
    """(1, T, di, n) for the first T at which the launch rule chunks T and
    leaves a last chunk of one step, of a chunk less one, and of a whole
    chunk."""
    from repro_torch.kernels.ssm_scan.kernel import plan
    found = {}
    for t in range(2, 4096):
        how = plan(1, t, di, n, sms)
        last = t - (how.chunks - 1) * how.chunk_len
        kind = {1: "one", how.chunk_len - 1: "less_one",
                how.chunk_len: "whole"}.get(last)
        if how.chunks >= 3 and kind and kind not in found:
            found[kind] = (1, t, di, n)
    check(len(found) == 3, f"chunk_edges({di}, {n}): found {found}")
    return list(found.values())


def _ssm_f64(x, dt, bm, cm, a):
    """The plain version's recurrence in float64 (y only)."""
    import torch
    xd, dd, bd, cd, ad = (v.double() for v in (x, dt, bm, cm, a))
    h = torch.zeros((x.shape[0], x.shape[2], bm.shape[-1]),
                    dtype=torch.float64, device=x.device)
    y = torch.empty(x.shape, dtype=torch.float64, device=x.device)
    for i in range(x.shape[1]):
        h = torch.exp(dd[:, i, :, None] * ad) * h \
            + (dd[:, i] * xd[:, i])[:, :, None] * bd[:, i, None, :]
        y[:, i] = torch.einsum("bdn,bn->bd", h, cd[:, i])
    return y


def _over_tol(got, want, tol: float) -> float:
    """max |got - want| / (tol (1 + |want|)): at most 1 is within
    ``torch.allclose(rtol=tol, atol=tol)``."""
    got, want = got.double(), want.double()
    return float(((got - want).abs() / (tol * (1 + want.abs()))).max())


def phase_ssm_kernel(paths: dict, reps: int = 5) -> dict:
    """``ssm_scan`` against its plain version on ``SSM_CASES``, the
    design's edges (``SSM_EDGE_CASES``, ``chunk_edges`` at Di 3200 and
    8192, ``SSM_LONG``) in f32 and bf16, and every prefill shape of
    ``paths`` (f32 x and dt, as prefill calls it: y leaves the scan in f32);
    then timed with CUDA events beside the plain version (one repetition:
    its Python loop launches about 8 kernels a step), the bound and the
    special-function floor at falcon-mamba-7b's shapes and at each path
    shape, each also by its device time alone (``_device_ms``), and where
    the launch rule chunks T, the same call unchunked.  ``paths``: {name:
    (cfg, launcher)}.

    ``SSM_LONG`` with a drawn as in ``tests/test_kernels.py`` (some a
    within 1e-4 of 0: memories longer than T) is held on h (2e-4) and bf16
    y (2e-2); its f32 y is recorded against the plain version and both
    against a float64 evaluation, since the plain version's own f32
    rounding is farther than 2e-4 from float64 there.  With a as the
    block initialises it (``model_a``) every output is held."""
    import torch

    from repro_torch.kernels.ssm_scan.kernel import (Plan, _sm_count,
                                                     launch, plan, ssm_scan)
    from repro_torch.kernels.ssm_scan.ref import ssm_scan_ref
    gen = torch.Generator(device="cuda").manual_seed(0)
    sms = _sm_count(torch.cuda.current_device())
    shapes = SSM_CASES + SSM_EDGE_CASES + chunk_edges(3200, 16, sms) \
        + chunk_edges(8192, 16, sms)
    checks = [(case, dtype, False) for case in shapes + [SSM_LONG]
              for dtype in ("float32", "bfloat16")]
    checks.append((SSM_LONG, "float32", True))
    for cfg, launcher in paths.values():
        checks += [((b, t, cfg.d_inner, cfg.ssm.d_state), "float32", False)
                   for b, t, _ in prefill_calls(launcher)]
    max_err = {"y_float32": 0.0, "y_bfloat16": 0.0, "h": 0.0}
    long_f32 = {}
    for (b, t, di, n), dtype, model_a in checks:
        args = _ssm_inputs(b, t, di, n, dtype, gen, model_a)
        y, h = ssm_scan(*args, return_state=True)
        y_ref, h_ref = ssm_scan_ref(*args, return_state=True)
        torch.cuda.synchronize()
        tol = SSM_TOL[dtype]
        over_y = _over_tol(y, y_ref, tol)
        over_h = _over_tol(h, h_ref, SSM_TOL["float32"])
        check(y.dtype == args[0].dtype and y.shape == args[0].shape
              and bool(torch.isfinite(y).all()),
              f"ssm_scan y: {(b, t, di, n)} {dtype} dtype, shape or finite")
        check(over_h <= 1, f"ssm_scan h != plain: {(b, t, di, n)} {dtype}, "
              f"{over_h} of the tolerance")
        max_err["h"] = max(max_err["h"], float((h - h_ref).abs().max()))
        err = float((y.float() - y_ref.float()).abs().max())
        if (b, t, di, n) == SSM_LONG and dtype == "float32" and not model_a:
            y64 = _ssm_f64(*args)
            long_f32 = {"case": SSM_LONG, "held": False,
                        "kernel_over_tol": over_y,
                        "plain_vs_float64_over_tol": _over_tol(y_ref, y64,
                                                               tol),
                        "kernel_vs_float64_over_tol": _over_tol(y, y64, tol),
                        "max_abs_err": err}
            del y64
        else:
            check(over_y <= 1, f"ssm_scan y != plain: {(b, t, di, n)} "
                  f"{dtype}{' model a' if model_a else ''}, {over_y} of the "
                  f"tolerance (max abs err {err})")
            max_err["y_" + dtype] = max(max_err["y_" + dtype], err)
        del args, y, h, y_ref, h_ref
    torch.cuda.empty_cache()
    clock_hz = max_sm_clock_hz()

    def timed(b, t, di, n):
        args = _ssm_inputs(b, t, di, n, "float32", gen)
        how = plan(b, t, di, n, sms)
        call = lambda: ssm_scan(*args, return_state=True)  # noqa: E731
        row = {"B": b, "T": t, "Di": di, "N": n, "lanes": how.lanes,
               "chunks": how.chunks, "kernels": how.kernels,
               "ms": _time_ms(call, reps), "device_ms": _device_ms(call),
               "plain_ms": _time_ms(lambda: ssm_scan_ref(
                   *args, return_state=True), 1)}
        if how.chunks > 1:
            one = Plan(how.lanes, 1, t, how.state_pad)
            row["unchunked_ms"] = _time_ms(lambda: launch(*args, one), reps)
            row["unchunked_device_ms"] = _device_ms(
                lambda: launch(*args, one))
        row.update(ssm_work(b, t, di, n, "float32"))
        # the exponentials the function needs, on every SM's special-
        # function units at the boost clock (chunking runs more)
        row["sfu_floor_ms"] = row["exps"] / (SFU_PER_CLOCK * sms
                                             * clock_hz) * 1e3
        del args
        torch.cuda.empty_cache()
        return row

    res = {"phase": "ssm_kernel", "name": "ssm_scan", "cases": len(checks),
           "tolerance": SSM_TOL, "max_abs_err": max_err,
           "long_float32_y": long_f32, "reps": reps, "sms": sms,
           "max_sm_clock_mhz": clock_hz / 1e6,
           "shapes": [timed(b, t, *SSM_TIMED_WIDTHS)
                      for b, t in TIMED_SHAPES]}
    rows = {name: [(timed(b, t, cfg.d_inner, cfg.ssm.d_state),
                    calls * cfg.n_layers)
                   for b, t, calls in prefill_calls(launcher)]
            for name, (cfg, launcher) in paths.items()}
    res["paths"] = {name: _sum_path(r, "float32")
                    for name, r in rows.items()}
    res["path"] = _sum_path([x for r in rows.values() for x in r],
                            "float32")
    emit(res)
    return res


# -------------------------------------------------------------- train
def _state_bytes_equal(a, b) -> bool:
    import torch

    from repro_torch import tree as tu
    fa, fb = tu.flatten_with_keys(a), tu.flatten_with_keys(b)
    if [k for k, _ in fa] != [k for k, _ in fb]:
        return False
    return all(x.shape == y.shape and x.dtype == y.dtype and torch.equal(
        x.reshape(-1).view(torch.uint8), y.reshape(-1).view(torch.uint8))
        for (_, x), (_, y) in zip(fa, fb))


def _round_breakdown(trainer) -> dict:
    """Host-clock ms of one unit's parts on a trained session (second of
    two calls, synchronised): the gradient, its quorum hash (device to
    host copy + blake2b) and the optimizer step."""
    import torch

    from repro_torch.core.elastic import grad_hash

    def timed(fn):
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = fn()
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    batch = trainer.stream.batch(0)
    (_, grads), grad_ms = timed(
        lambda: trainer.grad_fn(trainer.state.params, batch))
    _, hash_ms = timed(lambda: grad_hash(grads))
    _, apply_ms = timed(lambda: trainer.apply_fn(trainer.state, grads))
    return {"grad_fn": grad_ms, "grad_hash": hash_ms, "apply": apply_ms,
            "units_per_round": trainer.micro_batches}


def _peak_gb() -> float:
    """Peak device memory allocated since the last call, in GB."""
    import torch
    peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    return peak


def _release() -> None:
    """Free a finished session's device memory: a session's trainer and
    its respawn closure refer to each other, so only the cycle collector
    frees them."""
    import torch
    gc.collect()
    torch.cuda.empty_cache()


def _finite(state) -> bool:
    import torch

    from repro_torch import tree as tu
    return all(bool(torch.isfinite(x).all()) for x in tu.leaves(state)
               if x.is_floating_point())


def phase_train(cfg, workdir: Path) -> dict:
    import torch

    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    from repro_torch.launch import train

    outdir = str(workdir / "run")
    per_diff = len(path_launches(cfg))
    res = {"phase": "train", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "free_disk_gb": shutil.disk_usage(workdir).free / 1e9}

    # ---- the main path: every count to 0 just before, read just after
    fused_delta_tiles.launches = 0
    ops.reset_kernel_stats()
    peaks = {}
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    args_a = train.parse_args(["--steps", "4", "--snapshot-every", "2",
                               "--outdir", outdir])
    sess = train.build_trainer(cfg, args_a)
    res["params"] = sum(p.numel() for p in tu.leaves(sess.trainer.state.params))
    sum_a = train.train(sess, args_a)
    kinds = [sess.snaps.manifests[s].kind for s in sess.snaps.order]
    check(kinds == ["base", "diff"], f"snapshot kinds {kinds}")
    diff_info = sess.snaps.last_info
    stats_a = dict(ops.KERNEL_STATS)
    launches_a = fused_delta_tiles.launches
    peaks["train_4"] = _peak_gb()
    t_restore = time.perf_counter()
    restored, _ = sess.snaps.restore(target_tree=sess.trainer.state,
                                     device=sess.device)
    res["restore_s"] = time.perf_counter() - t_restore
    check(_state_bytes_equal(restored, sess.trainer.state),
          "restore of the diff snapshot != live state")
    peaks["restore"] = _peak_gb()
    del restored, sess
    _release()

    args_r = train.parse_args(["--steps", "2", "--snapshot-every", "2",
                               "--outdir", outdir, "--resume"])
    sess = train.build_trainer(cfg, args_r)
    check(sess.start_step == 4, f"resumed at {sess.start_step}")
    sum_r = train.train(sess, args_r)
    restored, _ = sess.snaps.restore(target_tree=sess.trainer.state,
                                     device=sess.device)
    check(_state_bytes_equal(restored, sess.trainer.state),
          "restore of the resumed run's snapshot != live state")
    check(_finite(sess.trainer.state), "non-finite state after training")
    peaks["resume_2"] = _peak_gb()
    del restored, sess
    _release()

    args_b = train.parse_args(["--steps", "6", "--snapshot-every", "0"])
    sess = train.build_trainer(cfg, args_b)
    sum_b = train.train(sess, args_b)
    peaks["train_6_no_snapshots"] = _peak_gb()
    launches = fused_delta_tiles.launches
    res["main_path_s"] = time.perf_counter() - t0
    res["round_ms"] = _round_breakdown(sess.trainer)
    del sess
    _release()

    losses = sum_a["losses"] + sum_r["losses"]
    check(all(math.isfinite(x) for x in losses), f"losses {losses}")
    # random init: the first loss sits near ln(vocab)
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {losses[0]} vs ln V {math.log(cfg.vocab_size)}")
    check(losses == sum_b["losses"],
          f"resumed losses {losses} != uninterrupted {sum_b['losses']}")
    check(launches_a == per_diff and launches == per_diff,
          f"kernel launches {launches_a}/{launches}, expected {per_diff} "
          "for the one diff snapshot")
    res.update({
        "losses": losses, "losses_bit_exact": True, "restore_exact": True,
        "launches": launches, "launches_per_diff_snapshot": per_diff,
        "tokens_per_s_with_snapshots": sum_a["tokens_per_s"],
        "tokens_per_s_no_snapshots": sum_b["tokens_per_s"],
        "diff_snapshot": {
            "kernel_ms": stats_a["kernel_ms"], "d2h_ms": stats_a["d2h_ms"],
            "probe_bytes": stats_a["probe_bytes"],
            "d2h_bytes": stats_a["d2h_bytes"],
            "plan_ms": diff_info.plan_ms, "stall_ms": diff_info.stall_ms,
            "bound_ms": (stats_a["probe_bytes"] + stats_a["d2h_bytes"])
            / HBM_BYTES_PER_S * 1e3},
        "peak_mem_gb": peaks,
    })
    emit(res)
    return res


# -------------------------------------------------------------- serve
def _checked(fn, flag):
    """Wrap a prefill or decode step: AND the finiteness of its logits
    into ``flag`` on the device (no synchronisation)."""
    import torch

    def step(*a):
        logits, caches = fn(*a)
        flag.logical_and_(torch.isfinite(logits).all())
        return logits, caches
    return step


def _isolated(cfg, run, params, prompt, n_new, max_len, forced=None):
    """Greedy batch-1 generation outside the engine; -> (the greedy token
    at each position, the logits that chose it).  With ``forced``, those
    tokens are fed instead of the greedy ones (teacher forcing)."""
    import torch

    from repro_torch.models import api
    prefill = api.make_prefill_step(cfg, max_len, run)
    decode = api.make_decode_step(cfg, run)
    lg, caches = prefill(params, {"tokens": prompt[None, :]})
    logits = [lg[0]]
    out = [int(torch.argmax(lg[0, :cfg.vocab_size]))]
    for i in range(n_new - 1):
        fed = out[-1] if forced is None else forced[i]
        lg, caches = decode(params, caches, {
            "tokens": torch.tensor([[fed]], device="cuda"),
            "index": len(prompt) + i})
        logits.append(lg[0, 0])
        out.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
    return out, torch.stack(logits)


def _trace(fn, top: int = 10) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall time, device
    time summed over kernels, the busy share (device / wall; the
    profiler's own host cost lowers it), the number of kernels and of
    host-side aten ops (nested ones included), and the kernels that took
    most device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = prof.key_averages()
    kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    return {"wall_ms": wall_ms, "device_ms": device_ms,
            "busy_share": device_ms / wall_ms if wall_ms else None,
            "kernel_launches": sum(e.count for e in kernels),
            "aten_ops": sum(e.count for e in rows
                            if e.device_type == DeviceType.CPU
                            and e.key.startswith("aten::")),
            "top": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                    for e in kernels[:top]]}


@contextlib.contextmanager
def _nondeterministic():
    """Deterministic algorithms off for the block, then as they were."""
    import torch
    on = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(on, warn_only=warn)


def _launched(kernels: dict, fn):
    """Run ``fn`` with every kernel's launch counter set to 0 just before;
    -> (fn's result, {name: launches}) read just after."""
    for k in kernels.values():
        k.launches = 0
    out = fn()
    return out, {name: k.launches for name, k in kernels.items()}


def _check_launches(what: str, counts: dict, expected: dict) -> None:
    check(counts == expected,
          f"{what}: kernel launches {counts}, expected {expected} (one per "
          "layer and prefill call of each kernel on the path)")


def _serve_launcher(cfg, kernels: dict, expected: dict) -> tuple:
    """(a) ``repro_torch.launch.serve`` on ``LAUNCHER``; -> (result,
    params, run)."""
    import numpy as np
    import torch

    from repro_torch import tree as tu
    from repro_torch.launch import serve
    args = serve.parse_args([
        "--requests", str(LAUNCHER["requests"]),
        "--prompt-len", str(LAUNCHER["prompt_len"]),
        "--gen", str(LAUNCHER["gen"])])
    torch.cuda.reset_peak_memory_stats()
    server = serve.build_server(cfg, args)
    res = {"params": sum(p.numel() for p in tu.leaves(server.params)),
           "build_peak_gb": _peak_gb()}
    summ, counts = _launched(kernels, lambda: serve.serve(server, args))
    res.update({
        "requests": args.requests, "prompt_len": args.prompt_len,
        "gen": args.gen, "prefill_s": summ["prefill_s"],
        "decode_s": summ["decode_s"],
        "decode_tokens_per_s": summ["decode_tokens_per_s"],
        "launches": counts, "peak_gb": _peak_gb()})
    _check_launches("launcher", counts, expected)
    check(summ["logits_finite"], "launcher: non-finite logits")
    check(np.asarray(summ["tokens"]).shape == (args.requests, args.gen),
          "launcher: wrong token count")
    params, run = server.params, server.run
    del server, summ
    _release()
    return res, params, run


def _serve_engine(cfg, params, run, kernels: dict, expected: dict) -> tuple:
    """(b) the continuous-batching engine on ``ENGINE_PROMPTS``; ->
    (result, prompts, finished requests by id)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Request, ServingEngine
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab_size, t).astype(np.int32)
               for t in ENGINE_PROMPTS]
    engine = ServingEngine(cfg, params, slots=ENGINE_SLOTS,
                           max_len=ENGINE_MAX_LEN, run=run)
    finite = torch.ones((), dtype=torch.bool, device="cuda")
    engine._prefill = _checked(engine._prefill, finite)
    engine._decode = _checked(engine._decode, finite)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reqs = [Request(i, p, n) for i, (p, n) in
            enumerate(zip(prompts, ENGINE_NEW))]

    def drive():
        t0 = time.perf_counter()
        out = engine.run_queue(reqs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0
    (done, wall), counts = _launched(kernels, drive)
    by_id = {r.request_id: r for r in done}
    n_tokens = sum(len(r.output) for r in done)
    res = {
        "slots": ENGINE_SLOTS, "max_len": ENGINE_MAX_LEN,
        "prompt_lens": list(ENGINE_PROMPTS), "new_tokens": list(ENGINE_NEW),
        "wall_s": wall, "tokens": n_tokens, "tokens_per_s": n_tokens / wall,
        "ttft_s": [by_id[i].first_token_s for i in range(len(reqs))],
        "done_s": [by_id[i].done_s for i in range(len(reqs))],
        "decode_steps": engine.stats["decode_steps"],
        "prefills": engine.stats["prefills"],
        "launches": counts, "peak_gb": _peak_gb()}
    _check_launches("engine", counts, expected)
    check(engine.stats["served"] == len(reqs),
          f"engine served {engine.stats['served']}")
    check(bool(finite), "engine: non-finite logits")
    check(all(len(by_id[i].output) == n for i, n in enumerate(ENGINE_NEW)),
          "engine: wrong token counts")
    del engine
    _release()
    return res, prompts, by_id


def _serve_checks(cfg, run, params, prompts, by_id, forward_tol: float,
                  later_tokens: bool) -> dict:
    """(c) each engine request against isolated batch-1 generation, and
    one request's prefill and decode logits against ``lm.forward_train``
    (the twins: ``blocked_attention``, the chunked associative scan).
    Batched decode is not batch-invariant on cuBLAS, so later tokens are
    only counted (with ``later_tokens``): free-running (one flip changes
    every later token) and teacher-forced (fed the engine's tokens, each
    position on its own)."""
    import numpy as np
    import torch

    from repro_torch.models import lm
    res = {}
    check_i = ENGINE_PROMPTS.index(1024)
    agree = forced_agree = total = 0
    for i, prompt in enumerate(prompts):
        mine = by_id[i].output
        n_new = ENGINE_NEW[i] if later_tokens or i == check_i else 1
        out, logits = _isolated(cfg, run, params, prompt, n_new,
                                ENGINE_MAX_LEN)
        check(bool(torch.isfinite(logits).all()),
              f"isolated request {i}: non-finite logits")
        check(out[0] == mine[0],
              f"request {i}: engine first token {mine[0]} != isolated "
              f"prefill's {out[0]}")
        if i == check_i:
            check_out, check_logits = out, logits
        if later_tokens:
            agree += sum(a == b for a, b in zip(out[1:], mine[1:]))
            forced, _ = _isolated(cfg, run, params, prompt, ENGINE_NEW[i],
                                  ENGINE_MAX_LEN, forced=mine)
            forced_agree += sum(a == b for a, b in zip(forced[1:], mine[1:]))
            total += len(out) - 1
    if later_tokens:
        res["later_tokens_agree_with_isolated"] = {
            "free_running": agree / total,
            "teacher_forced": forced_agree / total, "positions": total}
    seq = np.concatenate([prompts[check_i],
                          np.asarray(check_out[:-1], np.int32)])
    with torch.no_grad():
        full, _ = lm.forward_train(
            params, cfg, torch.as_tensor(seq, device="cuda")[None], run)
    start = len(prompts[check_i]) - 1
    want = full[0, start:start + len(check_out)].float()
    got = check_logits.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    res["forward_train_check"] = {
        "request": check_i, "positions": len(check_out),
        "max_abs_err": err, "logit_scale": scale,
        "rel_err": err / scale, "tolerance": forward_tol,
        "rms_rel_err": float((got - want).square().mean().sqrt()
                             / want.square().mean().sqrt()),
        "argmax_agree": float((got[:, :cfg.vocab_size].argmax(-1)
                               == want[:, :cfg.vocab_size].argmax(-1))
                              .float().mean())}
    check(err <= forward_tol * scale,
          f"prefill/decode logits vs forward_train: max abs err {err} "
          f"> {forward_tol} x logit scale {scale}")
    del full
    return res


def _serve_trace(cfg, run, params, prompt) -> dict:
    """(d) where the time goes: one batch-1 prefill of ``prompt``, then 8
    decode steps, each traced."""
    import torch

    from repro_torch.models import api
    prefill = api.make_prefill_step(cfg, ENGINE_MAX_LEN, run)
    decode = api.make_decode_step(cfg, run)
    box = {}

    def do_prefill():
        box["lg"], box["caches"] = prefill(params,
                                           {"tokens": prompt[None, :]})

    def do_decode():
        tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
        for j in range(8):
            box["lg"], box["caches"] = decode(
                params, box["caches"],
                {"tokens": tok, "index": len(prompt) + j})
    return {"prefill_T%d" % len(prompt): _trace(do_prefill),
            "decode_8_steps_B1": _trace(do_decode)}


def _path_kernels() -> dict:
    """The serving path's kernel wrappers, by name."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan
    return {"flash_attention": flash_attention, "ssm_scan": ssm_scan}


def per_prefill(cfg) -> dict:
    """Launches of each kernel per prefill call: one per layer where the
    family has the block (attention: dense and hybrid; scan: SSM and
    hybrid), none elsewhere."""
    return {"flash_attention": cfg.n_layers * (cfg.family != "ssm"),
            "ssm_scan": cfg.n_layers * (cfg.family in ("ssm", "hybrid"))}


def _serve(cfg, launcher: bool, forward_tol: float,
           later_tokens: bool) -> dict:
    """One configuration through the serving path: (a) the launcher (or,
    without it, ``build_server`` alone for the params), (b) the engine,
    (c) the checks, (d) the trace.  Each kernel's counter must read one
    launch per layer and prefill call where the family has its block, and
    none where it has not."""
    from repro_torch import tree as tu
    from repro_torch.launch import serve
    kernels, per_call = _path_kernels(), per_prefill(cfg)
    res = {"arch": cfg.name, "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "dtype": "bfloat16"}
    if launcher:
        res["launcher"], params, run = _serve_launcher(cfg, kernels,
                                                       per_call)
        res["params"] = res["launcher"].pop("params")
    else:
        _peak_gb()                                  # resets the peak
        server = serve.build_server(cfg, serve.parse_args([]))
        params, run = server.params, server.run
        res["params"] = sum(p.numel() for p in tu.leaves(params))
        res["build_peak_gb"] = _peak_gb()
        del server
    res["engine"], prompts, by_id = _serve_engine(
        cfg, params, run, kernels,
        {k: n * len(ENGINE_PROMPTS) for k, n in per_call.items()})
    res.update(_serve_checks(cfg, run, params, prompts, by_id, forward_tol,
                             later_tokens))
    res["trace"] = _serve_trace(cfg, run, params,
                                prompts[ENGINE_PROMPTS.index(1024)])
    del params
    _release()
    return res


def phase_serve(cfg, forward_tol: float = 0.1) -> dict:
    """granite-3-2b.  ``forward_tol``, relative to the largest |logit|:
    bf16 activations keep 8 significant bits, so each of the 40 layers
    adds noise of about 2**-8 of the residual stream, rounded at other
    places on the two routes (the kernel keeps its probabilities in f32,
    the twin rounds them to bf16; decode multiplies one row at a time,
    forward_train all rows at once); summed over 40 layers and maximised
    over 12 x 49k logits that comes to a few percent (4.2 % measured on
    the card).  A wrong head mapping, mask or cache row moves logits by
    their whole scale."""
    res = {"phase": "serve"}
    res.update(_serve(cfg, launcher=True, forward_tol=forward_tol,
                      later_tokens=True))
    emit(res)
    return res


def phase_serve_ssm(falcon, hymba, forward_tol: float = 0.1) -> dict:
    """falcon-mamba-7b through the launcher and the engine, then
    hymba-1.5b through the engine, both at full width.  ``forward_tol`` as
    for granite: the scan is f32 on both routes (sequential in the kernel,
    associative in the twin), so what differs is the bf16 rounding of the
    activations around it, over 64 and 32 layers.  Later tokens are not
    counted here (granite's phase counts them): isolated generation runs
    only where a check needs it."""
    res = {"phase": "serve_ssm",
           falcon.name: _serve(falcon, True, forward_tol, False),
           hymba.name: _serve(hymba, False, forward_tol, False)}
    emit(res)
    return res


def ssm_full_width(arch: str, n_layers: int):
    """The registered config, only ``n_layers`` cut (0 keeps them all):
    ``reduced`` would also shrink d_state and dt_rank."""
    from repro_torch.configs.base import get_arch
    cfg = get_arch(arch)
    return dataclasses.replace(cfg, n_layers=min(n_layers, cfg.n_layers)
                               or cfg.n_layers)


def _kernel_row(name, source, replaces, launches, max_err, path) -> dict:
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": max_err, "ms": path["ms"],
            "plain_ms": path["plain_ms"], "bound_ms": path["bound_ms"],
            "bound_by": path["bound_by"],
            "library_ms": path.get("library_ms")}


def main(argv=None) -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--phases", default=",".join(PHASES))
    ap.add_argument("--layers", type=int, default=4,
                    help="depth of the train phase")
    ap.add_argument("--serve-layers", type=int, default=40,
                    help="depth of the serve phase (granite-3-2b has 40)")
    ap.add_argument("--ssm-layers", type=int, default=0,
                    help="depth of the serve_ssm phase (0: all, 64 for "
                         "falcon-mamba-7b and 32 for hymba-1.5b)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails outside a checkout)
    cfg = granite_full_width(args.layers)
    serve_cfg = granite_full_width(args.serve_layers)
    falcon = ssm_full_width("falcon-mamba-7b", args.ssm_layers)
    hymba = ssm_full_width("hymba-1.5b", args.ssm_layers)
    # the serve drives whose prefills launch each kernel: (cfg, launcher)
    attn_paths = {"serve": (serve_cfg, True), "serve_ssm": (hymba, False)}
    ssm_paths = {"serve_ssm": (falcon, True), "serve_ssm_hybrid":
                 (hymba, False)}

    def phase_train_in_tmp(cfg):
        workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            return phase_train(cfg, workdir)
        finally:
            shutil.rmtree(workdir, ignore_errors=True)

    seconds = {}

    def run(name, fn, *a):
        """Run one phase if it was asked for, between two clock lines;
        -> its result or None."""
        if name not in phases:
            return None
        clocks(name, "before")
        t0 = time.perf_counter()
        out = fn(*a)
        seconds[name] = time.perf_counter() - t0
        clocks(name, "after")
        return out

    phase_gpu()
    run("build", phase_build)
    kern = run("kernel", phase_kernel, cfg)
    attn = run("attn_kernel", phase_attn_kernel, attn_paths)
    tr = run("train", phase_train_in_tmp, cfg)
    sv = run("serve", phase_serve, serve_cfg)
    ssm = run("ssm_kernel", phase_ssm_kernel, ssm_paths)
    sv_ssm = run("serve_ssm", phase_serve_ssm, falcon, hymba)
    # last, as standalone users run them: outside the train launcher's
    # deterministic mode, which fills every new allocation, outputs included
    with _nondeterministic():
        dops = run("delta_ops", phase_delta_ops, cfg)
        sprint = run("sprint", phase_sprint)
    emit({"phase_seconds": seconds})
    if None in (kern, dops, sprint, attn, tr, sv, ssm, sv_ssm):
        return 0
    # the launches counted on each main path's run, against the launches
    # each kernel phase timed
    f_name, h_name = falcon.name, hymba.name
    runs = {
        "flash_attention": {
            "serve": sv["launcher"]["launches"]["flash_attention"]
            + sv["engine"]["launches"]["flash_attention"],
            "serve_ssm": sv_ssm[h_name]["engine"]["launches"]
            ["flash_attention"]},
        "ssm_scan": {
            "serve_ssm": sv_ssm[f_name]["launcher"]["launches"]["ssm_scan"]
            + sv_ssm[f_name]["engine"]["launches"]["ssm_scan"],
            "serve_ssm_hybrid": sv_ssm[h_name]["engine"]["launches"]
            ["ssm_scan"]}}
    for name, timed in (("flash_attention", attn["paths"]),
                        ("ssm_scan", ssm["paths"])):
        for path, n in runs[name].items():
            check(n == timed[path]["launches"],
                  f"{name}: {path} launched {n} times, "
                  f"{timed[path]['launches']} timed")

    emit({"kernels": [
        _kernel_row("fused_delta_tiles", SOURCE, REPLACES, tr["launches"],
                    kern["max_abs_err"], {
                        "ms": kern["ms"], "plain_ms": kern["plain_ms"],
                        "bound_ms": kern["bound_ms"], "bound_by": "bytes"}),
        *(_kernel_row(name, SOURCE, DELTA_REPLACES[name],
                      dops["launches"][name], dops["max_abs_err"][name],
                      dops["paths"][name]) for name in DELTA_REPLACES),
        _kernel_row("flash_attention", ATTN_SOURCE, ATTN_REPLACES,
                    sum(runs["flash_attention"].values()),
                    max(attn["max_abs_err"].values()), attn["path"]),
        _kernel_row("ssm_scan", SSM_SOURCE, SSM_REPLACES,
                    sum(runs["ssm_scan"].values()),
                    max(ssm["max_abs_err"].values()), ssm["path"]),
        _kernel_row("pcor", PCOR_SOURCE, PCOR_REPLACES, sprint["launches"],
                    sprint["max_abs_err"]["plain"], sprint["path"])]})
    emit({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
