#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py                 # everything, as the check runs it
    python3 chip_smoke.py --phases build,kernel --layers 2
    python3 chip_smoke.py --phases build,train_uplink --layers 2
    python3 chip_smoke.py --phases build,ssm_kernel,serve_ssm --ssm-layers 2
    python3 chip_smoke.py --phases build,train_families
    python3 chip_smoke.py --phases build,attn_kernel,serve_moe --moe-layers 2
    python3 chip_smoke.py --phases build,attn_kernel,encdec --encdec-layers 2
    python3 chip_smoke.py --phases build,delta_ops
    python3 chip_smoke.py --phases build,sprint
    python3 chip_smoke.py --phases build,cells,examples
    python3 chip_smoke.py --phases build,attn_kernel,mesh

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
   changed; then, at the launch shapes of the train phase's diff
   snapshots (28 each, inline and async-writer), of the train_families
   phase's (hymba-1.5b's 32) and of the examples phase's quickstart (5
   diff snapshots of 2), checked again and timed with CUDA events
   beside the plain version and the bytes bound (every tile changed:
   3N), and the train phase's largest again with a random 10 % of its
   tiles changed, beside its own bytes (2N and the changed tiles).
4. ``attn_kernel``: ``flash_attention`` against its plain PyTorch
   version on the card, on ``tests/test_kernels.py``'s ``ATTN_CASES`` (hd
   32 to 256, MQA, S > T, ragged T and S) plus hd 16, in f32 (2e-5) and
   bf16 (2e-2), and on every prefill shape of the serve, serve_moe,
   encdec, cells and serve_ssm phases in bf16 (the encdec phase's causal
   decoder self-attention and its full encoder self-attention and
   cross-attention, plus the full T 1024 against a ragged S 1000 and
   1500), each both in the kernel's (B, H, T, hd) layout and through
   ``ops.attend`` on the model's (B, T, H, hd) tensors, as the path calls
   it; then timed with CUDA events beside the plain version
   and ``scaled_dot_product_attention`` (the library yardstick, used
   nowhere in the port: pinned to its flash backend, and under its
   default dispatch, whose backend is named; the faster of the two
   counts, at the call's causality) at granite-3-2b's prefill shapes in
   the kernel's layout and at every prefill shape of those phases
   through ``attend`` (the encdec phase's three groups one by one), each
   with its bound, the executed TFLOP/s of kernel and library, and the kernel's
   share of its bound.  At B 1, T 97 to 2000 and B 8, T 2048 a call of
   ``attend`` is split into the kernel's device time
   (``torch.profiler``), the host's time to issue it and its time on
   CUDA events; at B 8, T 2048 the bf16 output is held against float32
   references with P in float32 and with P rounded to bf16.
5. ``train``: ``repro_torch.launch.train`` at the full width of
   granite-3-2b (d_model 2048, 32 heads, 8 KV heads, d_ff 8192, vocab
   49155) and 4 of its 40 layers: 4 rounds with a snapshot every 2, a
   fresh ``--resume`` for 1 more (snapshotting it), and an uninterrupted
   5-round run whose losses must equal the first two's bit for bit;
   the newest snapshot must restore to the live state's exact bytes,
   and the kernel's launch counter must show the diff snapshot going
   through it.  The uninterrupted run snapshots with ``--async-writer``
   (the zero-stall writer: the round pays the probe and the copy, the
   hashing and store writes run on a background thread): its two
   manifests must equal the first run's but for their clock, and its
   snapshot stall is reported beside the inline one.  Last,
   ``NO_SNAPSHOT_ROUNDS`` rounds without snapshots give the training
   tokens/s alone; their losses must be the first run's.
6. ``train_uplink``: the same launcher at the same width and depth with
   ``--uplink --compress-grads`` (2 rounds of 2 units on 3 workers, no
   snapshots): each unit's gradient is quantized to int8 on the card and
   its image diffed there against the worker's previous one.  The probe's
   counter must read one launch per gradient leaf for every unit after a
   worker's first, the server must accept every unit and reject none,
   the losses must be finite, and the server's fold of the last unit must
   dequantize to a gradient whose hash is the quorum's.  Then one unit
   taken apart: the card's quantized image equal to the CPU's byte for
   byte, host ms of each step (quantize, image, probe, D2H,
   ``chunk_records``, encode, ``push_update``, ``decode_update``), the
   uplink bytes, and ``fused_delta_tiles`` at the unit's image shapes held
   bit for bit against its plain version and timed beside it and its
   bytes bound.  Last, the framework-neutral planes at 1 layer
   (``--replicas 1 --edge-caches 1 --shards 2 --rebalance --telemetry``):
   2 rounds with a snapshot every round, then a ``--resume`` whose state
   must equal the first run's live state byte for byte, both as the
   launcher restores it and again through the edge cache, and whose
   losses (1 more round) must equal an uninterrupted 3-round run's;
   ``events.jsonl`` must not be empty.
7. ``train_families``: the same launcher on the other decoder-only
   families, each at its published widths with only the depth cut:
   hymba-1.5b (hybrid, 4 of 32 layers, 297,793,600 params, a 3.57 GB
   state; 2 rounds with a snapshot every round, a base then a diff whose
   probe launches, one per size bucket of the state, are counted, and
   the newest snapshot restoring to the live state's bytes),
   falcon-mamba-7b (SSM, 1 of 64 layers, 637,992,960 params) and
   deepseek-moe-16b (MoE, 1 of 28 layers, 1,007,294,464 params), 2
   rounds each without snapshots.  The SSM trains through autograd of
   the chunked scan (the reference has no backward kernel).  Each: finite
   losses, the first near ln V, every unit completed, none invalid or
   reissued; then one unit taken apart (``grad_fn``, ``grad_hash``,
   ``apply`` ms), tokens/s, peak device memory and, for the MoE, the
   routing metrics (drop fraction, aux and z-losses) on batch 0.
8. ``serve``: granite-3-2b at full width and all 40 layers in bf16,
   (a) through ``repro_torch.launch.serve`` (8 requests of 1024 prompt
   tokens, 32 new tokens each, one batched prefill) and (b) through the
   continuous-batching ``ServingEngine`` (4 slots, 8 requests of 97 to
   2000 prompt tokens and 8 to 32 new tokens).  The flash-attention
   counter must read one launch per layer and prefill (40 and 320) and
   the scan's none, every logit must be finite, each engine request's
   first token must equal an isolated batch-1 prefill's, and one
   request's prefill and decode logits must match ``lm.forward_train``
   (the ``blocked_attention`` twin) over its prompt and generated tokens.
9. ``serve_moe``: deepseek-moe-16b (d_model 2048, 16 heads of 128, 64
   routed experts top 6 and 2 shared, vocab 102400) at all 28 layers in
   bf16, 16,879,568,896 params, through the launcher and the engine as
   in ``serve``, with its checks; the logits against the twin are held
   at a capacity factor of E / k, where no item is dropped (at the served
   1.25 the twin, one row of prompt and generated tokens, drops the
   latest tokens first, and a decode step drops none: that gap is
   recorded).  The attention kernel's counter must read 28 and 224.
10. ``encdec``: seamless-m4t-medium (the encoder-decoder: 12 + 12 layers,
   d_model 1024, 16 heads of 64, d_ff 4096, vocab 256206) at full width,
   977,860,608 params.  (a) A capsule booted on the card takes 2 steps at
   B 4, T 256 with frames (4, 256, 1024) from numpy seed 0, after one
   ``api.make_train_step`` step from the same state whose loss must
   equal the capsule's first; the losses finite, the first within 1 of
   ln V, the params finite after; step ms and peak memory.  (b) The serve
   launcher in bf16 on 8 prompts of 1024 tokens with 8 x 1024 frames, 32
   new tokens: the attention kernel's counter must read 36 (12 encoder
   and 12 cross-attention launches, full, 12 decoder ones, causal) and
   decode runs none.  (c) Request 0 generated alone, its prefill and
   decode logits against ``encdec.forward_train`` (the twin) over its
   prompt, its fed tokens and its frames, within 0.1 of the logit scale;
   then a capsule step, and request 0's prefill and 8 decode steps,
   each traced (``torch.profiler``).
11. ``cells``: ``repro_torch.launch.cell.build_cell`` on the card at
   granite-3-2b's full width and ``CELL_LAYERS`` layers, a train, a
   prefill and a decode cell at ``CELL_SHAPES``' small B and T, each step
   run twice and its outputs finite; its time and peak device memory
   beside the dry run's bytes and traced FLOPs for the same cell on the
   meta device (``launch.dryrun``, ``launch.flop_analysis``).  The
   prefills' flash-attention launches are counted (one per layer and
   call).
12. ``mesh``: the sharding layer, in two parts.  (a) On the card: an
   NCCL group of one and a (1, 1) ("data", "model") ``DeviceMesh``, and
   the cells phase's three cells built on it (every argument a DTensor,
   each step inside the rules): each step run ``CELL_RUNS`` times, its
   first outputs equal to the same cell built on ``"cuda"`` bit for bit,
   both step times, and the prefill's flash-attention launches counted
   on each (``CELL_RUNS`` x layers, the kernel on each rank's shard);
   then a capsule booted on the mesh (``"1x1:data,model"``) restores an
   unsharded snapshot of the train cell's state onto it bit for bit and
   steps it, equal to the capsule booted on the card.  (b) On the card's
   host, meanwhile: the dry run (``launch.dryrun``, meta DTensors over
   the ``fake`` backend) of granite-3-2b's ``train_4k``, ``prefill_32k``
   and ``decode_32k`` on ``single_pod`` and ``train_4k`` on
   ``multi_pod``, one process each, all started together: each ok, its
   per-device bytes finite, and each train cell's collective bytes above
   0; each cell's bytes per device, fit in 80 GB, collective seconds,
   dominant term and trace seconds are reported.
13. ``ssm_kernel``: ``ssm_scan`` against its plain PyTorch version on the
   card, y and the final state h, in f32 (2e-4) and bf16 (2e-2 for y), on
   ``tests/test_kernels.py``'s ``SSM_CASES`` (N 4 to 16, ragged T and
   Di), on the design's edges (N 1, 5, 24 and 32; T 1; Di no multiple of
   a block's channels; T whose last time chunk is one step, a chunk less
   one and a whole chunk; B 1, T 8192 at Di 3200, the long carry chain)
   and on every prefill shape of the serve_ssm and examples phases; then
   timed with
   CUDA events beside the plain version, the bound and the special-
   function floor (the exponentials at 16 a clock per SM) at
   falcon-mamba-7b's Di 8192 and N 16 (B 1 and 8, T 512 to 2048) and at
   every prefill shape of the serve_ssm phase, each row with its launch
   plan (lanes per channel, time chunks, CUDA kernels a call) and, where
   it chunks, the time of the same call unchunked.
14. ``serve_ssm``: falcon-mamba-7b (d_model 4096, d_inner 8192, N 16,
   vocab 65024) at all 64 layers in bf16 through the launcher and the
   engine as in ``serve``, then hymba-1.5b (d_model 1600, 25 heads, 5 KV
   heads, d_inner 3200, N 16) at all 32 layers through the engine, with
   the same checks against isolated prefills and the twin
   (``forward_train``: the chunked associative scan).  The scan's counter
   must read 64 and 512 for falcon and 256 for hymba, and the attention
   kernel's none for falcon and 256 for hymba.
15. ``examples``: ``examples/torch_quickstart.py``,
   ``torch_project_switch.py`` and ``torch_serve_capsule.py`` at
   ``device="cuda"``, each passing its own asserts; quickstart's diff
   snapshots must launch ``fused_delta_tiles`` once per size bucket of
   its state, serve_capsule's prefill ``ssm_scan`` once per layer.
16. ``delta_ops``: the one-shot delta API's kernels (``changed_bitmap``,
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
17. ``sprint``: the SPRINT correlation workload of the paper's Fig. 4 at
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
once, and outside a checkout of the repository it cannot import the
port's constants (``repro_torch.launch.mesh``) and fails.
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
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.launch import mesh  # noqa: E402  (fails outside a checkout)

# H100 SXM, NVIDIA data sheet: device memory rate, dense peak operations
HBM_BYTES_PER_S = mesh.HBM_BW
PEAK_OPS_PER_S = {"bfloat16": mesh.PEAK_FLOPS_BF16,
                  "float32": mesh.PEAK_FLOPS_FP32,
                  "tf32": mesh.PEAK_FLOPS_TF32}
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
PHASES = ("build", "kernel", "attn_kernel", "train", "train_uplink",
          "train_families", "serve", "serve_moe", "encdec", "cells",
          "mesh", "ssm_kernel", "serve_ssm", "examples", "delta_ops", "sprint")
# train_families: (arch, layers, launcher flags), each at its published
# widths with only the depth cut; the first (the hybrid) snapshots
FAMILY_DRIVES = (
    ("hymba-1.5b", 4, ("--steps", "2", "--snapshot-every", "1")),
    ("falcon-mamba-7b", 1, ("--steps", "2", "--snapshot-every", "0")),
    ("deepseek-moe-16b", 1, ("--steps", "2", "--snapshot-every", "0")))
# the encdec phase: seamless-m4t-medium's capsule steps at B 4, T 256
# (frames as long as the tokens), then the serve launcher on LAUNCHER;
# the attention kernel is also held at T 1024 against these ragged
# encoder lengths (non-causal)
ENCDEC_ARCH = "seamless-m4t-medium"
ENCDEC_TRAIN = {"batch": 4, "seq": 256, "steps": 2}
ENCDEC_RAGGED_S = (1000, 1500)
# the cells phase: granite-3-2b at full width, CELL_LAYERS of its 40
# layers, each kind at (B, T) (decode: one token against a cache of T),
# each step run CELL_RUNS times; the dry run's default remat
CELL_LAYERS = 2
CELL_SHAPES = {"train_4k": (2, 1024), "prefill_32k": (2, 2048),
               "decode_32k": (8, 2048)}
CELL_RUNS = 2
# the mesh phase's dry-run cells: (shape, mesh) of granite-3-2b at full
# width and depth, each traced in a process of its own
MESH_DRYRUN = (("train_4k", "single_pod"), ("prefill_32k", "single_pod"),
               ("decode_32k", "single_pod"), ("train_4k", "multi_pod"))
MESH_DRYRUN_TIMEOUT = 400
# the train_uplink phase's planes drive: granite-3-2b's depth cut to this
PLANES_LAYERS = 1
# the train phase's drive without snapshots (training tokens/s alone)
NO_SNAPSHOT_ROUNDS = 2
# the examples phase: examples/torch_*.py, and the launches each makes of
# the kernels: quickstart's 30 rounds snapshot every 5 (a base, then 5
# diffs of reduced granite-3-2b's state); serve_capsule prefills 4
# prompts of 24 tokens once on reduced falcon-mamba-7b
EXAMPLES = ("torch_quickstart", "torch_project_switch",
            "torch_serve_capsule")
QUICKSTART_DIFFS = 5
SERVE_CAPSULE_PREFILL = (4, 24, 1)
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


def phase_kernel(paths: dict, reps: int = 5) -> dict:
    """``paths``: {name: (cfg, diff snapshots)} of the drives whose diff
    snapshots launch the kernel; "train" (granite) also gives the
    top-level numbers (one snapshot's) and the random 10 % case."""
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

    # times at the training paths' launch shapes, every tile changed (as
    # AdamW leaves the state), each distinct shape timed once
    path_shapes = {name: path_launches(cfg)
                   for name, (cfg, _) in paths.items()}
    launches = path_shapes["train"]
    shape_rows = {}

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

    for nblk in sorted({n for ls in path_shapes.values() for n in ls}):
        o32 = torch.randint(-2**31, 2**31 - 1, (nblk, 8, 1024),
                            dtype=torch.int32, device="cuda", generator=gen)
        n32 = o32 ^ 1
        shape_rows[nblk] = timed(o32, n32)
        cases += 1
        del o32, n32
    torch.cuda.empty_cache()
    sums = {}
    for name, ls in path_shapes.items():
        moved = sum(shape_rows[n][2] for n in ls)
        sums[name] = {"launches": len(ls), "tiles": sum(ls),
                      "ms": sum(shape_rows[n][0] for n in ls),
                      "plain_ms": sum(shape_rows[n][1] for n in ls),
                      "bytes": moved,
                      "bound_ms": moved / HBM_BYTES_PER_S * 1e3,
                      "bound_by": "bytes"}
    train = sums["train"]
    # each path's diff snapshots, one snapshot's launches each
    for name, (_, snapshots) in paths.items():
        sums[name] = {k: v if k == "bound_by" else v * snapshots
                      for k, v in sums[name].items()}
        sums[name]["snapshots"] = snapshots

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
                "all_changed_ms": shape_rows[nblk][0],
                "all_changed_bytes": (3 * nblk) * TILE_BYTES + 4 * nblk}
    del o32, n32, picked
    torch.cuda.empty_cache()
    res = {"phase": "kernel", "name": "fused_delta_tiles", "cases": cases,
           "tolerance": "bit for bit", "max_abs_err": max_err,
           "launches_per_snapshot": train["launches"],
           "snapshot_tiles": train["tiles"], "ms": train["ms"],
           "plain_ms": train["plain_ms"], "bound_ms": train["bound_ms"],
           "bound_by": "bytes", "bytes": train["bytes"], "paths": sums,
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
    the larger of the operations (the kernel module's ``flops``, the count
    the dry run adds for each call) at the card's peak for the dtype and
    the bytes (q, k, v read once, o written once) at its memory rate."""
    from repro_torch.kernels.flash_attention.kernel import flops
    ops = flops(b, h, t, s, hd, causal)      # the dry run's count
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
    """(B, T, prefill calls) of one decoder-only configuration's serve
    drive: the launcher's one batched prefill (where it runs), then the
    engine's batch-1 prefills."""
    out = [(LAUNCHER["requests"], LAUNCHER["prompt_len"], 1)] \
        if launcher else []
    return out + [(1, t, ENGINE_PROMPTS.count(t))
                  for t in sorted(set(ENGINE_PROMPTS))]


def attn_groups(cfg, launcher: bool) -> list:
    """(group, B, T, S, causal, launches) of the attention kernel on one
    configuration's serve drive.  Decoder-only: one causal group per
    prefill shape, a launch per layer and call.  Encoder-decoder: the
    launcher's one prefill only (the reference's engine refuses the
    family), frames as long as the prompt, in three groups of a launch
    per layer: the decoder's causal self-attention, the encoder's full
    self-attention and the full cross-attention."""
    if cfg.enc_dec:
        b, t = LAUNCHER["requests"], LAUNCHER["prompt_len"]
        return [(group, b, t, t, causal, cfg.n_layers)
                for group, causal in (("decoder_self", True),
                                      ("encoder_self", False),
                                      ("cross", False))]
    return [(f"B{b}_T{t}", b, t, t, True, calls * cfg.n_layers)
            for b, t, calls in prefill_calls(launcher)]


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


def _sdpa(q, k, v, causal: bool = True):
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                          enable_gqa=True)


def _time_sdpa(q, k, v, reps: int, causal: bool = True) -> dict:
    """SDPA at the kernel call's causality (T = S where causal)."""
    import torch
    from torch.nn.attention import SDPBackend, sdpa_kernel
    with sdpa_kernel([getattr(SDPBackend, SDPA_FLASH)]):
        flash = _time_ms(lambda: _sdpa(q, k, v, causal), reps)
    default = _time_ms(lambda: _sdpa(q, k, v, causal), reps)
    picked = SDPBackend(torch._fused_sdp_choice(
        q, k, v, is_causal=causal, enable_gqa=True)).name
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
    """``paths``: {name: (cfg, groups)} of the drives whose prefills launch
    the kernel, each group (name, B, T, S, causal, launches)."""
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
    for cfg, groups in paths.values():
        shapes = [(b, t, s, causal) for _, b, t, s, causal, _ in groups]
        if cfg.enc_dec:     # the encoder's length need not be the prompt's
            b, t = LAUNCHER["requests"], LAUNCHER["prompt_len"]
            shapes += [(b, t, s, False) for s in ENCDEC_RAGGED_S]
        checks += [((b, t, s, *heads(cfg), causal), "bfloat16", model)
                   for b, t, s, causal in dict.fromkeys(shapes)
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

    def timed(b, t, s, hs, causal=True, model=False):
        """The kernel's time at one shape, in the kernel's layout or, with
        ``model``, through ``attend`` in the model's (the serving path's
        call); the plain version and SDPA on the same views, at the same
        causality."""
        h, kh, hd = hs
        q, k, v = _attn_inputs(b, t, s, h, kh, hd, "bfloat16", gen, model)
        if model:
            ms = _time_ms(lambda: attend(q, k, v, causal=causal), reps)
            q, k, v = _heads_first(q, k, v)
        else:
            ms = _time_ms(lambda: flash_attention(q, k, v, causal=causal),
                          reps)
        row = {"B": b, "T": t, "S": s, "causal": causal, "ms": ms,
               "plain_ms": _time_ms(
                   lambda: attention_ref(q, k, v, causal=causal), reps)}
        row.update(_time_sdpa(q, k, v, reps, causal))
        row.update(attn_work(b, t, s, h, kh, hd, causal, "bfloat16"))
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
           "shapes": [timed(b, t, t, GRANITE_HEADS)
                      for b, t in TIMED_SHAPES],
           "split": [split(b, t) for b, t in SPLIT_SHAPES],
           "p_rounding": _p_rounding(gen)}
    # each serve drive's main path, as it runs: attend on the model's
    # layout, each group's launches (attn_groups)
    groups = {name: g for name, (_, g) in paths.items()}
    rows = {name: [(timed(b, t, s, heads(paths[name][0]), causal, True), n)
                   for _, b, t, s, causal, n in g]
            for name, g in groups.items()}
    res["paths"] = {name: _sum_path(r, "bfloat16")
                    for name, r in rows.items()}
    res["groups"] = {name: [{"group": g[0], "launches": n, **row}
                            for g, (row, n) in zip(groups[name], r)]
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
    the final h written in f32, each once.  Operations: the kernel
    module's ``flops`` (per state element and step dt*a, exp(.)*h,
    (dt x)*b, +, c*h and the sum over N (6), per channel and step dt*x
    (1), all f32), the count the dry run adds for each call; the
    exponentials are counted apart (``exps``), on the special-function
    units."""
    from repro_torch.kernels.ssm_scan.kernel import flops
    esize = 2 if dtype == "bfloat16" else 4
    nbytes = esize * 3 * b * t * di + 4 * (2 * b * t * n + di * n
                                           + b * di * n)
    ops = flops(b, t, di, n)                 # the dry run's count
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
    (cfg, [(B, T, prefill calls)])}.

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
    for cfg, calls in paths.values():
        checks += [((b, t, cfg.d_inner, cfg.ssm.d_state), "float32", False)
                   for b, t, _ in calls]
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
                    n * cfg.n_layers) for b, t, n in calls]
            for name, (cfg, calls) in paths.items()}
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
    """Host-clock ms of one unit's parts on a trained session, whose
    rounds have warmed each of them (one synchronised call each): the
    gradient, its quorum hash (device to host copy + blake2b) and the
    optimizer step."""
    import torch

    from repro_torch.core.elastic import grad_hash

    def timed(fn):
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


def _manifests(snaps) -> list:
    """A snapshot manager's manifests in order, as JSON, but the clock."""
    out = []
    for sid in snaps.order:
        m = json.loads(snaps.manifests[sid].to_json())
        m.pop("created")
        out.append(m)
    return out


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
    inline_manifests = _manifests(sess.snaps)
    del restored, sess
    _release()
    seconds = {"inline": time.perf_counter() - t0}
    t = time.perf_counter()

    args_r = train.parse_args(["--steps", "1", "--snapshot-every", "1",
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
    seconds["resume"], t = time.perf_counter() - t, time.perf_counter()

    # uninterrupted, with the zero-stall writer: the round pays only the
    # probe and the copy; its snapshots (rounds 2 and 4) must be the
    # inline drive's
    args_b = train.parse_args(["--steps", "5", "--snapshot-every", "2",
                               "--outdir", str(workdir / "async"),
                               "--async-writer"])
    sess = train.build_trainer(cfg, args_b)
    sum_b = train.train(sess, args_b)
    check(_manifests(sess.snaps) == inline_manifests,
          "async-writer manifests != the inline drive's")
    async_diff = sess.snaps.last_info
    peaks["train_5_async_writer"] = _peak_gb()
    del sess
    _release()
    seconds["async_writer"], t = time.perf_counter() - t, time.perf_counter()

    # without snapshots: the rounds alone; its losses must be the inline
    # drive's first ones
    args_d = train.parse_args(["--steps", str(NO_SNAPSHOT_ROUNDS),
                               "--snapshot-every", "0"])
    sess = train.build_trainer(cfg, args_d)
    sum_d = train.train(sess, args_d)
    peaks[f"train_{NO_SNAPSHOT_ROUNDS}_no_snapshots"] = _peak_gb()
    launches = fused_delta_tiles.launches
    res["main_path_s"] = time.perf_counter() - t0
    seconds["no_snapshots"] = time.perf_counter() - t
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
    check(sum_d["losses"] == losses[:NO_SNAPSHOT_ROUNDS],
          f"losses without snapshots {sum_d['losses']} != {losses}")
    check(launches_a == per_diff and launches == 2 * per_diff,
          f"kernel launches {launches_a}/{launches}, expected {per_diff} "
          f"for the one diff snapshot of each of the inline and the "
          f"async-writer drives")
    res.update({
        "losses": losses, "losses_bit_exact": True, "restore_exact": True,
        "launches": launches, "launches_per_diff_snapshot": per_diff,
        "tokens_per_s_with_snapshots": sum_a["tokens_per_s"],
        "tokens_per_s_no_snapshots": sum_d["tokens_per_s"],
        "diff_snapshot": {
            "kernel_ms": stats_a["kernel_ms"], "d2h_ms": stats_a["d2h_ms"],
            "probe_bytes": stats_a["probe_bytes"],
            "d2h_bytes": stats_a["d2h_bytes"],
            "plan_ms": diff_info.plan_ms, "stall_ms": diff_info.stall_ms,
            "bound_ms": (stats_a["probe_bytes"] + stats_a["d2h_bytes"])
            / HBM_BYTES_PER_S * 1e3},
        "async_writer": {
            "manifests_equal_inline": True,
            "snapshot_stall_ms": sum_b["snapshot_stall_ms"],
            "inline_snapshot_stall_ms": sum_a["snapshot_stall_ms"],
            "diff_stall_ms": async_diff.stall_ms,
            "diff_plan_ms": async_diff.plan_ms,
            "diff_writer_ms": async_diff.writer_ms,
            "inline_diff_stall_ms": diff_info.stall_ms,
            "tokens_per_s": sum_b["tokens_per_s"],
            "writer": sum_b.get("snapshot_writer")},
        "peak_mem_gb": peaks, "seconds": seconds,
    })
    emit(res)
    return res


# ------------------------------------------------------- train_uplink
UPLINK_ARGS = ["--uplink", "--compress-grads", "--steps", "2", "--micro",
               "2", "--workers", "3", "--snapshot-every", "0"]
PLANE_FLAGS = ["--replicas", "1", "--edge-caches", "1", "--shards", "2",
               "--rebalance"]


def _host_peak_gb() -> float:
    """Peak resident host memory of this process so far, in GB."""
    import resource
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _synced_ms(fn):
    """-> (fn's result, host ms from a synchronised start to a
    synchronised end)."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def _uplink_unit(trainer, reps: int = 5) -> dict:
    """One uplink unit taken apart on the trained model's gradients of
    batches 0 and 1 (batch 0's image is the encoder's previous round):
    the quantizer on the card against the CPU, byte for byte; host ms of
    quantize, image, the probe (``KERNEL_STATS`` events) and its D2H copy,
    ``chunk_records``, ``encode`` whole, ``push_update`` and
    ``decode_update``; then ``fused_delta_tiles`` at the unit's image
    shapes, held bit for bit against its plain version and timed beside
    it and its bytes bound."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.uplink import (UplinkEncoder, decode_update,
                                         flatten_compressed, leaf_image,
                                         push_update)
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import (as_i32_tiles,
                                                         fused_delta_tiles)
    from repro_torch.kernels.delta_encode.ref import fused_tiles_ref
    from repro_torch.optim import grad_compress as gc

    params = trainer.state.params
    _, g0 = trainer.grad_fn(params, trainer.stream.batch(0))
    _, g1 = trainer.grad_fn(params, trainer.stream.batch(1))
    comp0, _ = gc.compress(g0, gc.init_error(g0))
    del g0
    comp1, q_ms = _synced_ms(lambda: gc.compress(g1, gc.init_error(g1))[0])
    res = {"quantize_ms": q_ms}

    # the quantizer on the card against its CPU run, byte for byte
    g_cpu = tu.tree_map(lambda v: v.cpu(), g1)
    c_cpu, _ = gc.compress(g_cpu, gc.init_error(g_cpu))
    card = flatten_compressed(comp1)
    for key, c in flatten_compressed(c_cpu).items():
        check(torch.equal(leaf_image(card[key]).cpu(), leaf_image(c)),
              f"quantized image of {key}: card != CPU")
    res["quantizer_equal_cpu"] = True
    del g1, g_cpu, c_cpu

    imgs0 = {k: leaf_image(c) for k, c in flatten_compressed(comp0).items()}
    imgs1, res["image_ms"] = _synced_ms(
        lambda: {k: leaf_image(c) for k, c in card.items()})
    hosts0 = {k: v.cpu().numpy() for k, v in imgs0.items()}
    mirror = ops.DeviceMirror()
    for k, v in imgs0.items():
        ops.seed_slot(mirror, k, v.view(torch.int32))
    ops.reset_kernel_stats()
    probes, probe_wall = _synced_ms(lambda: {
        k: ops.changed_blocks(torch.from_numpy(hosts0[k]).view(torch.int32),
                              v.view(torch.int32), mirror=mirror,
                              mirror_key=k)
        for k, v in imgs1.items()})
    stats = ops.reset_kernel_stats()
    cb = trainer.uplink_chunk_bytes
    t = time.perf_counter()
    for k, (tiles, bitmap, nbytes) in probes.items():
        ops.chunk_records(hosts0[k], tiles, bitmap, nbytes, cb)
    res.update({"probe_ms": stats["kernel_ms"], "d2h_ms": stats["d2h_ms"],
                "probe_wall_ms": probe_wall,
                "chunk_records_ms": (time.perf_counter() - t) * 1e3,
                "d2h_bytes": stats["d2h_bytes"],
                "changed_tiles": sum(int(b.sum()) for _, b, _ in
                                     probes.values()),
                "tiles": sum(int(b.size) for _, b, _ in probes.values())})
    del probes, mirror

    enc, server = UplinkEncoder(chunk_bytes=cb), ChunkStore()
    push_update(enc.encode(comp0), server, client_id="w")
    update, res["encode_ms"] = _synced_ms(lambda: enc.encode(comp1))
    (moved, dedup), res["push_update_ms"] = _synced_ms(
        lambda: push_update(update, server, client_id="w"))
    dec, res["decode_update_ms"] = _synced_ms(
        lambda: decode_update(server, update))
    for k, c in dec.items():
        check(torch.equal(leaf_image(c), imgs1[k].cpu()),
              f"decoded image of {k} != the unit's")
    res.update({"dense_bytes": update.dense_bytes, "moved": moved,
                "dedup": dedup})
    del update, dec, enc, server

    # the kernel at the unit's image shapes: checked, then timed
    shapes, ms = [], {"ms": 0.0, "plain_ms": 0.0, "bytes": 0}
    for k in imgs1:
        o32, _ = as_i32_tiles(imgs0[k].view(torch.int32))
        n32, _ = as_i32_tiles(imgs1[k].view(torch.int32))
        bm, tiles = fused_delta_tiles(o32, n32)
        bm_ref, tiles_ref = fused_tiles_ref(o32, n32)
        changed = int(bm_ref.sum())
        check(torch.equal(bm, bm_ref)
              and torch.equal(tiles[:changed], tiles_ref),
              f"fused_delta_tiles != plain at the image of {k}")
        del bm, tiles, bm_ref, tiles_ref
        nblk = o32.shape[0]
        row = {"leaf": k, "tiles": nblk, "changed": changed,
               "ms": _time_ms(lambda: fused_delta_tiles(o32, n32), reps),
               "plain_ms": _time_ms(lambda: fused_tiles_ref(o32, n32), reps),
               "bytes": (2 * nblk + changed) * ops.TILE_BYTES + 4 * nblk}
        shapes.append(row)
        for key in ms:
            ms[key] += row[key]
        del o32, n32
    ms["bound_ms"] = ms["bytes"] / HBM_BYTES_PER_S * 1e3
    ms["bound_by"] = "bytes"
    res["kernel"] = {**ms, "shapes": shapes, "reps": reps}
    return res


def _planes_drive(cfg, workdir: Path) -> dict:
    """``PLANE_FLAGS`` with ``--telemetry`` at ``PLANES_LAYERS``: 2 rounds
    with a snapshot every round, a base then a diff (the probe's counter must
    show the diff snapshot); a fresh ``--resume``, whose state must equal
    the first run's live state byte for byte, restored again through the
    edge tier (``restore_latest(client_hashes=set())``: the route must
    name an edge cache, the bytes must be the same), then one more round;
    its losses against an uninterrupted 3-round run's, bit for bit."""
    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    from repro_torch.launch import train
    from repro_torch.models import api

    outdir, tel = workdir / "planes", workdir / "telemetry"
    res = {"layers": cfg.n_layers,
           "free_disk_gb": shutil.disk_usage(workdir).free / 1e9}
    seconds = {}
    t0 = time.perf_counter()
    flags = PLANE_FLAGS + ["--telemetry", str(tel)]
    args_a = train.parse_args(flags + ["--steps", "2", "--snapshot-every",
                                       "1", "--outdir", str(outdir)])
    sess = train.build_trainer(cfg, args_a)
    fused_delta_tiles.launches = 0
    sum_a = train.train(sess, args_a)
    launches, per_diff = fused_delta_tiles.launches, len(path_launches(cfg))
    check(launches == per_diff,
          f"planes: {launches} probe launches, expected {per_diff} for the "
          "one diff snapshot")
    live = tu.tree_map(lambda t: t.clone(), sess.trainer.state)
    res["free_disk_gb_after"] = shutil.disk_usage(workdir).free / 1e9
    del sess
    _release()
    seconds["run"] = time.perf_counter() - t0

    t = time.perf_counter()
    args_r = train.parse_args(flags + ["--steps", "1", "--snapshot-every",
                                       "2", "--outdir", str(outdir),
                                       "--resume"])
    sess = train.build_trainer(cfg, args_r)
    check(sess.start_step == 2, f"planes: resumed at {sess.start_step}")
    check(_state_bytes_equal(sess.trainer.state, live),
          "planes: the resumed state != the first run's live state")
    seconds["resume"] = time.perf_counter() - t
    t = time.perf_counter()
    nxt = sess.trainer.restore_latest(api.state_specs(cfg),
                                      client_hashes=set())
    plan = sess.trainer.last_restore_plan
    check(nxt == 2 and plan["route"].startswith("edge-"),
          f"planes: restore through the edge gave {nxt}, {plan}")
    check(_state_bytes_equal(sess.trainer.state, live),
          "planes: the state restored through the edge != the live state")
    del live
    seconds["edge_restore"] = time.perf_counter() - t
    t = time.perf_counter()
    sum_r = train.train(sess, args_r)
    del sess
    _release()
    seconds["resumed_round"] = time.perf_counter() - t

    t = time.perf_counter()
    args_b = train.parse_args(PLANE_FLAGS + ["--steps", "3",
                                             "--snapshot-every", "0"])
    sess = train.build_trainer(cfg, args_b)
    sum_b = train.train(sess, args_b)
    del sess
    _release()
    seconds["uninterrupted"] = time.perf_counter() - t
    losses = sum_a["losses"] + sum_r["losses"]
    check(losses == sum_b["losses"],
          f"planes: resumed losses {losses} != uninterrupted "
          f"{sum_b['losses']}")
    events = (tel / "events.jsonl").read_text().splitlines()
    check(len(events) > 0, "planes: events.jsonl is empty")
    kinds = sorted({json.loads(e)["kind"] for e in events})
    res.update({
        "seconds": seconds, "losses": losses, "launches": launches,
        "restore_plan": plan, "replication": sum_a["replication"],
        "edge": {k: v for k, v in sum_r["edge"].items() if k != "caches"},
        "shard_plane": sum_a["shard_plane"],
        "rebalance_splits": sum_a["rebalance_splits"],
        "telemetry": sum_r["telemetry"], "event_kinds": kinds,
        "snapshot_stall_ms": sum_a["snapshot_stall_ms"],
        "tokens_per_s": [sum_a["tokens_per_s"], sum_b["tokens_per_s"]]})
    return res


def phase_train_uplink(cfg, planes_cfg, workdir: Path) -> dict:
    """``repro_torch.launch.train`` with ``UPLINK_ARGS`` on ``cfg`` (the
    main path: every count to 0 just before it, read just after), its
    checks, one unit taken apart (``_uplink_unit``), then the planes
    drive on ``planes_cfg``."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.core.elastic import grad_hash
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    from repro_torch.launch import train
    from repro_torch.optim import grad_compress as gc

    res = {"phase": "train_uplink", "arch": cfg.name,
           "layers": cfg.n_layers, "d_model": cfg.d_model,
           "vocab": cfg.vocab_size, "args": UPLINK_ARGS}
    args = train.parse_args(UPLINK_ARGS)
    res["host_rss_gb_before"] = _host_peak_gb()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: every count to 0 just before, read just after
    fused_delta_tiles.launches = 0
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    sess = train.build_trainer(cfg, args)
    summary = train.train(sess, args)
    launches = fused_delta_tiles.launches
    stats = ops.reset_kernel_stats()
    res["main_path_s"] = time.perf_counter() - t0
    res["peak_mem_gb"] = _peak_gb()
    res["peak_host_rss_gb"] = _host_peak_gb()

    tr = sess.trainer
    encs = tr._uplink_enc.values()
    units = sum(e.units for e in encs)
    diffed = sum(e.units - 1 for e in encs)     # after each worker's first
    n_leaves = len(tu.leaves(tr.state.params))
    check(diffed > 0 and launches == n_leaves * diffed
          and sum(e.diffs for e in encs) == launches,
          f"fused_delta_tiles launched {launches} times, expected "
          f"{n_leaves} for each of {diffed} units after a worker's first")
    up = summary["uplink"]
    check(units == args.steps * args.micro and up["accepted"] == units
          and up["rejected"] == 0,
          f"uplink accepted {up['accepted']}, rejected {up['rejected']} "
          f"of {units} units")
    check(all(math.isfinite(x) for x in summary["losses"]),
          f"losses {summary['losses']}")
    check(abs(summary["losses"][0] - math.log(cfg.vocab_size)) < 1.0,
          f"first loss {summary['losses'][0]}")
    # the server's fold of the last unit: the quorum's gradient
    last = max(sess.server.projects["train"].canonical_updates)
    dec, fold_ms = _synced_ms(
        lambda: sess.server.resolve_round_update("train", last))
    flat = dict(tu.flatten_with_keys(tr.state.params))
    grads = tu.unflatten_like(tr.state.params, {
        k: gc.decompress_leaf(dec[k], flat[k].shape) for k in flat})
    check(grad_hash(grads) == tr.sched.units[last].canonical,
          f"unit {last}: the server's fold != the quorum's hash")
    del dec, grads
    hist = tr.history
    res.update({
        "losses": summary["losses"], "units": units, "diffed_units": diffed,
        "leaves": n_leaves, "launches": launches,
        "tokens_per_s": summary["tokens_per_s"],
        "uplink": {k: v for k, v in up.items() if k != "worker_credit"},
        "uplink_bytes": {"dense": sum(h.uplink_dense for h in hist),
                         "moved": sum(h.uplink_moved for h in hist),
                         "dedup": sum(h.uplink_dedup for h in hist)},
        "probe": {"kernel_ms": stats["kernel_ms"], "d2h_ms": stats["d2h_ms"],
                  "probe_bytes": stats["probe_bytes"],
                  "d2h_bytes": stats["d2h_bytes"]},
        "fold_unit": last, "fold_ms": fold_ms, "fold_hash_equal": True})
    res["unit"] = _uplink_unit(tr)
    del tr, sess
    _release()
    res["planes"] = _planes_drive(planes_cfg, workdir)
    emit(res)
    return res


# ----------------------------------------------------- train_families
def _family_drive(cfg, flags: tuple) -> dict:
    """``repro_torch.launch.train`` with ``flags`` on ``cfg`` (the main
    path: every count to 0 just before it, read just after), then its
    checks: finite losses, the first near ln V, every unit completed and
    none invalid or reissued; with snapshots, a base then a diff, the
    probe's launches those of one diff snapshot (one per size bucket of
    the state) and the newest snapshot restoring to the live state's
    bytes; without, no launch.  Then one unit taken apart
    (``_round_breakdown``) and, for an MoE, the routing metrics of the
    trained model on batch 0."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.kernels.delta_encode import ops
    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.models.lm import RunConfig

    args = train.parse_args(list(flags))
    res = {"arch": cfg.name, "family": cfg.family, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "args": list(flags)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    # ---- the main path: every count to 0 just before, read just after
    fused_delta_tiles.launches = 0
    ops.reset_kernel_stats()
    t0 = time.perf_counter()
    sess = train.build_trainer(cfg, args)
    state = sess.trainer.state
    res["params"] = sum(p.numel() for p in tu.leaves(state.params))
    res["state_gb"] = sum(x.numel() * x.element_size()
                          for x in tu.leaves(state)) / 1e9
    del state
    summary = train.train(sess, args)
    launches = fused_delta_tiles.launches
    stats = ops.reset_kernel_stats()
    res["main_path_s"] = time.perf_counter() - t0
    res["peak_mem_gb"] = _peak_gb()

    losses = summary["losses"]
    check(len(losses) == args.steps
          and all(math.isfinite(x) for x in losses),
          f"{cfg.name}: losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"{cfg.name}: first loss {losses[0]} vs ln V "
          f"{math.log(cfg.vocab_size)}")
    units, sched = args.steps * args.micro, summary["scheduler"]
    check(sched["completed"] == units and sched["invalid_results"] == 0
          and sched["reissued"] == 0,
          f"{cfg.name}: {sched} for {units} units")
    if args.snapshot_every:
        kinds = [sess.snaps.manifests[s].kind for s in sess.snaps.order]
        check(kinds == ["base", "diff"], f"{cfg.name}: snapshot kinds {kinds}")
        per_diff = len(path_launches(cfg))
        check(launches == per_diff,
              f"{cfg.name}: {launches} probe launches, expected {per_diff} "
              "for the one diff snapshot")
        info = sess.snaps.last_info
        t = time.perf_counter()
        restored, _ = sess.snaps.restore(target_tree=sess.trainer.state,
                                         device=sess.device)
        res["restore_s"] = time.perf_counter() - t
        check(_state_bytes_equal(restored, sess.trainer.state),
              f"{cfg.name}: restore of the diff snapshot != live state")
        del restored
        res["diff_snapshot"] = {
            "kernel_ms": stats["kernel_ms"], "d2h_ms": stats["d2h_ms"],
            "probe_bytes": stats["probe_bytes"],
            "d2h_bytes": stats["d2h_bytes"], "plan_ms": info.plan_ms,
            "stall_ms": info.stall_ms,
            "bound_ms": (stats["probe_bytes"] + stats["d2h_bytes"])
            / HBM_BYTES_PER_S * 1e3}
    else:
        check(launches == 0, f"{cfg.name}: {launches} probe launches "
              "without snapshots")
    if cfg.is_moe:
        tokens = torch.as_tensor(sess.trainer.stream.batch(0)["tokens"],
                                 device=sess.device)
        with torch.no_grad():
            _, metrics = lm.forward_train(
                sess.trainer.state.params, cfg, tokens,
                RunConfig(remat="none", block_kv=min(args.seq, 512)))
        res["moe"] = {k: float(v) for k, v in metrics.items()}
    res["round_ms"] = _round_breakdown(sess.trainer)
    res.update({"launches": launches, "losses": losses,
                "tokens_per_s": summary["tokens_per_s"],
                "wall_s": summary["wall_s"],
                "snapshot_stall_ms": summary["snapshot_stall_ms"]})
    del sess
    _release()
    return res


def phase_train_families(drives: list) -> dict:
    """``drives``: [(cfg, launcher flags)], each through ``_family_drive``;
    the probe's launches summed over them."""
    res = {"phase": "train_families"}
    for cfg, flags in drives:
        res[cfg.name] = _family_drive(cfg, flags)
    res["launches"] = sum(res[cfg.name]["launches"] for cfg, _ in drives)
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


def _isolated(cfg, run, params, prompt, n_new, max_len, frames=None):
    """Greedy batch-1 generation outside the engine; -> (the greedy token
    at each position, the logits that chose it).  An encoder-decoder's
    prefill also takes the request's ``frames``."""
    import torch

    from repro_torch.models import api
    prefill = api.make_prefill_step(cfg, max_len, run)
    decode = api.make_decode_step(cfg, run)
    batch = {"tokens": prompt[None, :]}
    if frames is not None:
        batch["frames"] = frames[None]
    lg, caches = prefill(params, batch)
    logits = [lg[0]]
    out = [int(torch.argmax(lg[0, :cfg.vocab_size]))]
    for i in range(n_new - 1):
        lg, caches = decode(params, caches, {
            "tokens": torch.tensor([[out[-1]]], device="cuda"),
            "index": len(prompt) + i})
        logits.append(lg[0, 0])
        out.append(int(torch.argmax(lg[0, 0, :cfg.vocab_size])))
    return out, torch.stack(logits)


def _trace(fn, top: int = 10, cross_check: bool = False) -> dict:
    """Run ``fn`` once under ``torch.profiler``: host wall time, device
    time summed over kernels, the busy share (device / wall; the
    profiler's own host cost lowers it), the number of kernels and of
    host-side aten ops (nested ones included), and the kernels that took
    most device time.  The numbers are read off the profiler's raw events
    (``_event_counts``), as ``key_averages`` would give them in many
    times the host time; with ``cross_check`` they are held against
    ``key_averages``."""
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
    t0 = time.perf_counter()
    device_us, launches, aten_ops, by_name = _event_counts(prof)
    res = {"wall_ms": wall_ms, "device_ms": device_us / 1e3,
           "busy_share": device_us / 1e3 / wall_ms if wall_ms else None,
           "kernel_launches": launches, "aten_ops": aten_ops,
           "top": [[k[:80], us / 1e3, n] for k, (us, n) in sorted(
               by_name.items(), key=lambda kv: kv[1][0], reverse=True)[:top]],
           "read_s": time.perf_counter() - t0}
    if cross_check:
        rows = prof.key_averages()
        kernels = [e for e in rows if e.device_type == DeviceType.CUDA]
        want = (sum(e.count for e in kernels),
                sum(e.count for e in rows if e.device_type == DeviceType.CPU
                    and e.key.startswith("aten::")))
        want_us = sum(e.self_device_time_total for e in kernels)
        check((launches, aten_ops) == want
              and math.isclose(device_us, want_us, rel_tol=1e-9),
              f"trace: raw events give {launches} kernels, {aten_ops} aten "
              f"ops, {device_us} us; key_averages {want}, {want_us} us")
        res["cross_checked"] = True
    return res


def _event_counts(prof) -> tuple:
    """(device us, device events, aten ops, {kernel: (us, count)}) of a
    finished ``torch.profiler.profile``, from its raw events, counted as
    ``key_averages`` counts them: the profiler's utility ops left out,
    async events out of the host nesting, and an op whose only child on
    its thread is the same op (a redispatch) counted once."""
    import itertools

    from torch.autograd import DeviceType
    from torch.autograd.profiler import _filter_name
    events = [e for e in prof.profiler.kineto_results.events()
              if not _filter_name(e.name())
              and not getattr(e, "is_hidden_event", lambda: False)()]
    device_us, launches, by_name = 0.0, 0, {}
    host = []
    for e in events:
        sync = not e.is_async() and e.start_thread_id() == e.end_thread_id()
        if e.device_type() == DeviceType.CPU:
            if sync:
                host.append((e.start_thread_id(), e.start_ns(), -e.end_ns(),
                             e.name()))
        elif e.device_type() == DeviceType.CUDA:
            us = (e.end_ns() - e.start_ns()) / 1e3 if sync else 0.0
            device_us += us
            launches += 1
            t, n = by_name.get(e.name(), (0.0, 0))
            by_name[e.name()] = (t + us, n + 1)
    # each host op's parent: the innermost op on its thread whose interval
    # holds it (ops sorted by start, the longer first)
    host.sort()
    parent, children = [None] * len(host), [0] * len(host)
    for _, group in itertools.groupby(range(len(host)),
                                      key=lambda i: host[i][0]):
        stack = []
        for i in group:
            start, end = host[i][1], -host[i][2]
            while stack and (start >= -host[stack[-1]][2]
                             or end > -host[stack[-1]][2]):
                stack.pop()
            if stack:
                parent[i] = stack[-1]
                children[stack[-1]] += 1
            stack.append(i)
    aten_ops = sum(
        1 for i, (_, _, _, name) in enumerate(host)
        if name.startswith("aten::") and not (
            parent[i] is not None and host[parent[i]][3] == name
            and children[parent[i]] == 1))
    return device_us, launches, aten_ops, by_name


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


def _serve_checks(cfg, run, params, prompts, by_id,
                  forward_tol: float) -> dict:
    """(c) each engine request's first token against an isolated batch-1
    prefill's, and one request's prefill and decode logits against
    ``lm.forward_train`` (the twins: ``blocked_attention``, the chunked
    associative scan).  Batched decode is not batch-invariant on cuBLAS,
    so later tokens are not compared."""
    import torch

    res = {}
    check_i = ENGINE_PROMPTS.index(1024)
    for i, prompt in enumerate(prompts):
        mine = by_id[i].output
        n_new = ENGINE_NEW[i] if i == check_i else 1
        out, logits = _isolated(cfg, run, params, prompt, n_new,
                                ENGINE_MAX_LEN)
        check(bool(torch.isfinite(logits).all()),
              f"isolated request {i}: non-finite logits")
        check(out[0] == mine[0],
              f"request {i}: engine first token {mine[0]} != isolated "
              f"prefill's {out[0]}")
        if i == check_i:
            check_out, check_logits = out, logits
    prompt = prompts[check_i]
    gap = _twin_gap(cfg, run, params, prompt, check_out, check_logits)
    if cfg.is_moe:
        # at the served capacity the two routes drop different items: the
        # twin's row holds the prompt and the generated tokens and drops
        # the latest first, a decode step (one token a row) drops none.
        # That gap is recorded; the check runs both at a capacity factor
        # of E / k, where an expert can take every item of a row
        res["forward_train_at_served_capacity"] = gap
        twin_run = dataclasses.replace(
            run, capacity_factor=cfg.moe.n_experts / cfg.moe.top_k)
        out, logits = _isolated(cfg, twin_run, params, prompt,
                                ENGINE_NEW[check_i], ENGINE_MAX_LEN)
        gap = _twin_gap(cfg, twin_run, params, prompt, out, logits)
    res["forward_train_check"] = {"request": check_i, **gap,
                                  "tolerance": forward_tol}
    check(gap["max_abs_err"] <= forward_tol * gap["logit_scale"],
          f"prefill/decode logits vs forward_train: max abs err "
          f"{gap['max_abs_err']} > {forward_tol} x logit scale "
          f"{gap['logit_scale']}")
    return res


def _twin_gap(cfg, run, params, prompt, out, logits, frames=None) -> dict:
    """An isolated generation's prefill and decode ``logits`` (its tokens
    ``out``) against ``lm.forward_train`` (an encoder-decoder's
    ``encdec.forward_train`` over the same ``frames``) over the prompt
    and the fed tokens, in one call."""
    import numpy as np
    import torch

    from repro_torch.models import encdec, lm
    seq = torch.as_tensor(np.concatenate(
        [prompt, np.asarray(out[:-1], np.int32)]), device="cuda")[None]
    with torch.no_grad():
        if frames is not None:
            full, metrics = encdec.forward_train(
                params, cfg, torch.as_tensor(frames, device="cuda")[None],
                seq, run)
        else:
            full, metrics = lm.forward_train(params, cfg, seq, run)
    start = len(prompt) - 1
    want = full[0, start:start + len(out)].float()
    got = logits.float()
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    return {
        "positions": len(out), "max_abs_err": err, "logit_scale": scale,
        "rel_err": err / scale,
        "rms_rel_err": float((got - want).square().mean().sqrt()
                             / want.square().mean().sqrt()),
        "argmax_agree": float((got[:, :cfg.vocab_size].argmax(-1)
                               == want[:, :cfg.vocab_size].argmax(-1))
                              .float().mean()),
        **({"metrics": {k: float(v) for k, v in metrics.items()}}
           if metrics else {})}


def _serve_trace(cfg, run, params, prompt, frames=None) -> dict:
    """(d) where the time goes: one batch-1 prefill of ``prompt`` (with an
    encoder-decoder's ``frames``), then 8 decode steps, each traced."""
    import torch

    from repro_torch.models import api
    prefill = api.make_prefill_step(cfg, ENGINE_MAX_LEN, run)
    decode = api.make_decode_step(cfg, run)
    box = {}
    batch = {"tokens": prompt[None, :]}
    if frames is not None:
        batch["frames"] = frames[None]

    def do_prefill():
        box["lg"], box["caches"] = prefill(params, batch)

    def do_decode():
        tok = torch.ones((1, 1), dtype=torch.int32, device="cuda")
        for j in range(8):
            box["lg"], box["caches"] = decode(
                params, box["caches"],
                {"tokens": tok, "index": len(prompt) + j})
    return {"prefill_T%d" % len(prompt): _trace(do_prefill,
                                                 cross_check=True),
            "decode_8_steps_B1": _trace(do_decode)}


def _path_kernels() -> dict:
    """The serving path's kernel wrappers, by name."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention
    from repro_torch.kernels.ssm_scan.kernel import ssm_scan
    return {"flash_attention": flash_attention, "ssm_scan": ssm_scan}


def per_prefill(cfg) -> dict:
    """Launches of each kernel per prefill call: one per layer where the
    family has the block (attention: dense, hybrid and encoder-decoder,
    whose layers have three: the encoder's, the decoder's self- and
    cross-attention; scan: SSM and hybrid), none elsewhere."""
    return {"flash_attention": cfg.n_layers * (cfg.family != "ssm")
            * (3 if cfg.enc_dec else 1),
            "ssm_scan": cfg.n_layers * (cfg.family in ("ssm", "hybrid"))}


def _serve(cfg, launcher: bool, forward_tol: float) -> dict:
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
    seconds, t = {}, time.perf_counter()
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
    seconds["launcher" if launcher else "build"], t = \
        time.perf_counter() - t, time.perf_counter()
    res["engine"], prompts, by_id = _serve_engine(
        cfg, params, run, kernels,
        {k: n * len(ENGINE_PROMPTS) for k, n in per_call.items()})
    seconds["engine"], t = time.perf_counter() - t, time.perf_counter()
    res.update(_serve_checks(cfg, run, params, prompts, by_id,
                             forward_tol))
    seconds["checks"], t = time.perf_counter() - t, time.perf_counter()
    res["trace"] = _serve_trace(cfg, run, params,
                                prompts[ENGINE_PROMPTS.index(1024)])
    seconds["trace"] = time.perf_counter() - t
    res["seconds"] = seconds
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
    res.update(_serve(cfg, launcher=True, forward_tol=forward_tol))
    emit(res)
    return res


def phase_serve_ssm(falcon, hymba, forward_tol: float = 0.1) -> dict:
    """falcon-mamba-7b through the launcher and the engine, then
    hymba-1.5b through the engine, both at full width.  ``forward_tol`` as
    for granite: the scan is f32 on both routes (sequential in the kernel,
    associative in the twin), so what differs is the bf16 rounding of the
    activations around it, over 64 and 32 layers."""
    res = {"phase": "serve_ssm",
           falcon.name: _serve(falcon, True, forward_tol),
           hymba.name: _serve(hymba, False, forward_tol)}
    emit(res)
    return res


def phase_serve_moe(cfg, forward_tol: float = 0.1) -> dict:
    """deepseek-moe-16b through the launcher and the engine at full width,
    with ``phase_serve``'s checks (first tokens against isolated
    prefills, logits against the twin within ``forward_tol`` of their
    scale).  Each prefill layer is one
    attention launch; the MoE block runs no kernel of the port (the
    reference's has none)."""
    res = {"phase": "serve_moe",
           cfg.name: _serve(cfg, True, forward_tol)}
    emit(res)
    return res


def _encdec_train(cfg) -> dict:
    """(a) A seamless-m4t-medium capsule booted on the card takes
    ``ENCDEC_TRAIN["steps"]`` steps at B 4, T 256 under the train
    launcher's deterministic settings, with frames (4, 256, 1024) float32
    from numpy seed 0; one ``api.make_train_step`` step from the same
    state first (its loss must equal the capsule's first, bit for bit:
    the same forward on the same inputs).  Checks: finite losses, the
    first within 1 of ln V, finite params after the steps."""
    import numpy as np
    import torch

    from repro_torch import tree as tu
    from repro_torch.core.capsule import CapsuleSpec, boot
    from repro_torch.distributed.sharding import init_tree
    from repro_torch.launch.train import resolve_device
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    resolve_device("cuda")
    run = RunConfig(remat="none")
    spec = CapsuleSpec(cfg.name, "train_4k", run, arch_override=cfg)
    booted = boot(spec, "cuda", verify_hash=spec.manifest_hash)
    _peak_gb()                                          # resets the peak
    specs = api.state_specs(cfg)
    gen = torch.Generator(device="cuda").manual_seed(0)
    state = api.TrainState(init_tree(specs.params, gen, device="cuda"),
                           init_tree(specs.opt, gen, device="cuda"))
    b, t = ENCDEC_TRAIN["batch"], ENCDEC_TRAIN["seq"]
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cfg.vocab_size, (b, t + 1)).astype(np.int32)
    batch = {"tokens": tokens[:, :-1], "labels": tokens[:, 1:],
             "frames": rng.standard_normal((b, t, cfg.d_model))
             .astype(np.float32)}
    res = {"params": sum(p.numel() for p in tu.leaves(state.params)),
           "batch": b, "seq": t, "frames": [b, t, cfg.d_model],
           "boot_wall_s": booted.boot_wall_s}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3
    (new, metrics), res["make_train_step_ms"] = timed(
        lambda: api.make_train_step(cfg, run)(state, batch))
    api_loss = float(metrics["loss"])
    del new, metrics
    losses, step_ms = [], []
    for _ in range(ENCDEC_TRAIN["steps"]):
        (state, loss), ms = timed(lambda: booted.step(state, batch))
        losses.append(float(loss))
        step_ms.append(ms)
    res.update({"losses": losses, "step_ms": step_ms,
                "make_train_step_loss": api_loss,
                "tokens_per_s": [b * t / ms * 1e3 for ms in step_ms],
                "peak_gb": _peak_gb(), "ln_vocab": math.log(cfg.vocab_size),
                # one more step, traced and dropped: where a step's time goes
                "trace_step": _trace(lambda: booted.step(state, batch))})
    check(all(math.isfinite(x) for x in losses),
          f"encdec train: non-finite losses {losses}")
    check(abs(losses[0] - math.log(cfg.vocab_size)) < 1.0,
          f"encdec train: first loss {losses[0]} not within 1 of ln V")
    check(api_loss == losses[0],
          f"encdec train: make_train_step loss {api_loss} != the "
          f"capsule's {losses[0]}")
    check(_finite(state.params), "encdec train: non-finite params")
    del state
    _release()
    return res


def phase_encdec(cfg, forward_tol: float = 0.1) -> dict:
    """seamless-m4t-medium at full width (12 + 12 layers, 977,860,608
    params), bf16 serving: (a) the capsule's training steps
    (``_encdec_train``); (b) ``repro_torch.launch.serve`` on
    ``LAUNCHER``, 8 prompts of 1024 tokens with frames of 1024, 32 new
    tokens: the attention kernel's counter must read 3 x 12 for the one
    prefill (the encoder's and the cross-attention's full, the decoder's
    causal) and decode none; (c) request 0's prefill and decode logits,
    generated alone, against ``encdec.forward_train`` over its prompt,
    the fed tokens and its frames, within ``forward_tol`` of the logit
    scale, as for the decoder-only families.  The kernel's timings on
    this path are the ``attn_kernel`` phase's ``encdec`` groups."""
    import numpy as np

    res = {"phase": "encdec", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "train": _encdec_train(cfg)}
    serve, params, run = _serve_launcher(cfg, _path_kernels(),
                                         per_prefill(cfg))
    res["params"] = serve.pop("params")
    res["serve"] = {"dtype": "bfloat16", **serve}
    rng = np.random.default_rng(0)      # the launcher's draws, request 0
    prompts = rng.integers(0, cfg.vocab_size, (
        LAUNCHER["requests"], LAUNCHER["prompt_len"])).astype(np.int32)
    frames = rng.standard_normal((LAUNCHER["requests"],
                                  LAUNCHER["prompt_len"], cfg.d_model)
                                 ).astype(np.float32)
    max_len = LAUNCHER["prompt_len"] + LAUNCHER["gen"]
    out, logits = _isolated(cfg, run, params, prompts[0], LAUNCHER["gen"],
                            max_len, frames=frames[0])
    gap = _twin_gap(cfg, run, params, prompts[0], out, logits, frames[0])
    res["forward_train_check"] = {"request": 0, **gap,
                                  "tolerance": forward_tol}
    check(gap["max_abs_err"] <= forward_tol * gap["logit_scale"],
          f"encdec prefill/decode logits vs forward_train: max abs err "
          f"{gap['max_abs_err']} > {forward_tol} x logit scale "
          f"{gap['logit_scale']}")
    res["trace"] = _serve_trace(cfg, run, params, prompts[0], frames[0])
    del params, logits
    _release()
    emit(res)
    return res


# -------------------------------------------------------------- cells
def cell_shape(name: str):
    """``SHAPES[name]`` cut to ``CELL_SHAPES``' (B, T)."""
    from repro_torch.configs.base import SHAPES
    b, t = CELL_SHAPES[name]
    return dataclasses.replace(SHAPES[name], global_batch=b, seq_len=t)


def phase_cells(cfg) -> dict:
    """``launch.cell.build_cell`` on the card for each kind at
    ``CELL_SHAPES`` (granite-3-2b at full width, ``CELL_LAYERS`` layers,
    the dry run's ``RunConfig``): the step run ``CELL_RUNS`` times (a
    train step on the state it returned, a decode step at the same
    index), its outputs finite, its time, and the peak device memory of
    the build and the first step (the cell's arguments, outputs and
    temporaries; eager PyTorch donates nothing, so a train step holds the
    old state beside the new) against the dry run's bytes for the same
    cell, traced on meta
    (``dryrun.cell_bytes``, ``flop_analysis``).  The peak must hold at
    least the cell's arguments.  The prefills' flash-attention launches,
    counted from 0 over the phase's steps, must read CELL_RUNS x layers;
    the kernel phase times them (path ``cells``)."""
    import torch

    from repro_torch import tree as tu
    from repro_torch.launch import flop_analysis
    from repro_torch.launch.cell import build_cell
    from repro_torch.launch.dryrun import cell_bytes
    from repro_torch.models.lm import RunConfig
    run = RunConfig()
    kernels = _path_kernels()
    res = {"phase": "cells", "arch": cfg.name, "layers": cfg.n_layers,
           "d_model": cfg.d_model, "vocab": cfg.vocab_size,
           "run": {"remat": run.remat, "compute_dtype": "bfloat16"},
           "cells": {}}

    def drive():
        for name in CELL_SHAPES:
            shape = cell_shape(name)
            _release()
            torch.cuda.reset_peak_memory_stats()
            cell = build_cell(cfg, shape, "cuda", run)
            args, ms = cell.args, []
            for i in range(CELL_RUNS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = cell.step(*args)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                if i == 0:      # the build and one step: what a cell needs
                    peak = torch.cuda.max_memory_allocated()
                if cell.kind == "train":
                    args = (out[0], args[1])
            check(all(bool(torch.isfinite(x).all())
                      for x in tu.leaves(out) if x.is_floating_point()),
                  f"cells: {name} output not finite")
            del cell, args, out
            meta = build_cell(cfg, shape, "meta", run)
            t0 = time.perf_counter()
            flops = flop_analysis.traced_flops(meta.step, *meta.args)
            trace_s = time.perf_counter() - t0
            nbytes = cell_bytes(cfg, shape, run)
            mem = flop_analysis.memory_dict(meta, run)
            check(peak >= mem["argument_size_in_bytes"],
                  f"cells: {name} peak {peak} B under its arguments' "
                  f"{mem['argument_size_in_bytes']} B")
            res["cells"][name] = {
                "B": shape.global_batch, "T": shape.seq_len,
                "kind": meta.kind, "step_ms": ms,
                "peak_bytes": peak, "dryrun_bytes": nbytes,
                "peak_over_dryrun_total": peak / nbytes["total"],
                "memory_analysis": mem, "traced_flops": flops,
                "trace_s": trace_s,
                "tflops_per_s": flops / (ms[-1] / 1e3) / 1e12}
            del meta

    _, res["launches"] = _launched(kernels, drive)
    _release()
    _check_launches("cells", res["launches"],
                    {"flash_attention": CELL_RUNS * cfg.n_layers,
                     "ssm_scan": 0})
    emit(res)
    return res


# --------------------------------------------------------------- mesh
def _start_dryruns(workdir: Path) -> list:
    """The mesh phase's dry-run cells, each in a process of its own (CPU
    only: meta DTensors over the ``fake`` backend), all started at once;
    -> [(shape, mesh, process, log path)]."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    started = []
    for shape, mesh_name in MESH_DRYRUN:
        log = workdir / f"dryrun_{shape}_{mesh_name}.log"
        with open(log, "w") as f:
            proc = subprocess.Popen(
                [sys.executable, "-m", "repro_torch.launch.dryrun",
                 "--arch", "granite-3-2b", "--shape", shape, "--mesh",
                 mesh_name, "--out", str(workdir / "dryrun")],
                stdout=f, stderr=subprocess.STDOUT, env=env, cwd=ROOT)
        started.append((shape, mesh_name, proc, log))
    return started


def _finish_dryruns(started: list, workdir: Path) -> dict:
    """Wait for each dry-run process (killed past the timeout); check and
    summarise its record."""
    out = {}
    deadline = time.monotonic() + MESH_DRYRUN_TIMEOUT
    for shape, mesh_name, proc, log in started:
        try:
            rc = proc.wait(timeout=max(deadline - time.monotonic(), 1))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
            rc = "timeout"
        path = workdir / "dryrun" / f"granite-3-2b__{shape}__{mesh_name}.json"
        check(rc == 0 and path.exists(),
              f"mesh: dry run of {shape} on {mesh_name} exited {rc}: "
              f"{log.read_text()[-2000:]}")
        rec = json.loads(path.read_text())
        roof = rec["roofline"]
        check(rec["status"] == "ok", f"mesh: dry run {shape} {mesh_name}: "
              f"{rec.get('error')}")
        check(all(math.isfinite(v) for v in rec["bytes"].values()),
              f"mesh: dry run {shape} {mesh_name}: bytes {rec['bytes']}")
        if shape == "train_4k":
            check(roof["collective_output_bytes"] > 0,
                  f"mesh: dry run {shape} {mesh_name} moved no collective "
                  "bytes")
        out[f"{shape}@{mesh_name}"] = {
            "n_devices": rec["n_devices"],
            "bytes_per_device": rec["bytes"], "fits_80gb": rec["fits_80gb"],
            "collective_op_counts": roof["collective_op_counts"],
            "collective_output_bytes": roof["collective_output_bytes"],
            "collective_wire_bytes_per_device":
                roof["collective_wire_bytes_per_device"],
            "compute_s": roof["compute_s"], "memory_s": roof["memory_s"],
            "collective_s": roof["collective_s"],
            "dominant": roof["dominant"], "trace_s": rec["trace_s"],
            "traced_flops_global": rec["traced_flops_global"]}
    return out


def _local_leaves(tree) -> list:
    """(path, tensor) of a tree, DTensors as their local tensors (on a
    mesh of one, the whole)."""
    from torch.distributed.tensor import DTensor

    from repro_torch import tree as tu
    return [(k, v.to_local() if isinstance(v, DTensor) else v)
            for k, v in tu.flatten_with_keys(tree)]


def _bit_diffs(got, want) -> dict:
    """{path: max |difference|} of the leaves that are not bit for bit
    equal (dtype and shape included)."""
    import torch
    g, w = _local_leaves(got), _local_leaves(want)
    check([k for k, _ in g] == [k for k, _ in w], "mesh: output trees differ")
    out = {}
    for (key, a), (_, b) in zip(g, w):
        if not torch.is_tensor(b):
            continue
        if a.dtype != b.dtype or a.shape != b.shape or not torch.equal(a, b):
            same = a.shape == b.shape
            out[key or "."] = float((a.double() - b.double()).abs().max()) \
                if same and a.numel() else "shape/dtype"
    return out


def _mesh_cells(cfg, m, kernels: dict, device: str = "cuda") -> tuple:
    """(a)'s cells: each kind on ``device`` and on the (1, 1) mesh of it;
    -> ({kind: row}, the device train cell's state)."""
    import torch

    from repro_torch.launch.cell import build_cell
    from repro_torch.models.lm import RunConfig
    run = RunConfig()
    out = {}
    for name in CELL_SHAPES:
        shape = cell_shape(name)
        row, firsts = {}, {}
        for label, where in (("card", device), ("mesh", m)):
            _release()
            cell = build_cell(cfg, shape, where, run)

            def drive():
                args, ms, first = cell.args, [], None
                for i in range(CELL_RUNS):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    res = cell.step(*args)
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
                    if i == 0:    # a decode cache is written in place
                        first = [(k, v.clone()) for k, v in
                                 _local_leaves(res)]
                    if cell.kind == "train":
                        args = (res[0], args[1])
                return first, ms

            (firsts[label], row[f"{label}_step_ms"]), \
                row[f"{label}_launches"] = _launched(kernels, drive)
            if label == "card":
                state = cell.args[0] if cell.kind == "train" else None
            del cell
        diffs = _bit_diffs(dict(firsts["mesh"]), dict(firsts["card"]))
        row["bit_equal"] = not diffs
        row["diffs"] = diffs
        check(not diffs, f"mesh: {name} on the (1, 1) mesh differs from "
              f"the card's cell: {diffs}")
        want = CELL_RUNS * cfg.n_layers if shape.kind == "prefill" else 0
        for label in ("card", "mesh"):
            _check_launches(f"mesh: {name} on the {label}",
                            row[f"{label}_launches"],
                            {"flash_attention": want, "ssm_scan": 0})
        out[name] = row
        if state is not None:
            train_state = state
    return out, train_state


def _mesh_capsule(cfg, m, state, workdir: Path,
                  device: str = "cuda") -> dict:
    """A capsule booted on the (1, 1) mesh: an unsharded snapshot of
    ``state`` restored onto it bit for bit, and one step equal to the
    capsule booted on the card."""
    import torch

    from repro_torch.core import capsule
    from repro_torch.core.chunkstore import ChunkStore
    from repro_torch.core.snapshots import SnapshotManager
    from repro_torch.launch.cell import concrete_batch
    from repro_torch.models import api
    from repro_torch.models.lm import RunConfig
    spec = capsule.CapsuleSpec("granite-3-2b", "train_4k", RunConfig(),
                               arch_override=cfg)
    t0 = time.perf_counter()
    booted = capsule.boot(spec, m)
    boot_s = time.perf_counter() - t0
    check(booted.device_desc == "1x1:data,model",
          f"mesh: capsule on {booted.device_desc}")
    sm = SnapshotManager(ChunkStore(workdir / "store"))
    sm.snapshot(state, step=1)
    specs = api.state_specs(cfg)
    t0 = time.perf_counter()
    placed, _ = sm.restore(target_tree=specs, device=device,
                           rules=booted.rules)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    diffs = _bit_diffs(placed, state)
    check(not diffs, f"mesh: snapshot restored onto the mesh differs: "
          f"{diffs}")
    batch = {k: torch.as_tensor(v, device=device) for k, v in
             concrete_batch(cfg, cell_shape("train_4k")).items()}
    new, loss = booted.step(placed, batch)
    del placed
    want_new, want_loss = capsule.boot(spec, device).step(state, batch)
    step_diffs = _bit_diffs((new, loss), (want_new, want_loss))
    check(not step_diffs, f"mesh: capsule step on the mesh differs: "
          f"{step_diffs}")
    return {"desc": booted.device_desc, "manifest_hash": spec.manifest_hash,
            "boot_s": boot_s, "restore_s": restore_s,
            "loss": float(want_loss), "bit_equal": True}


def phase_mesh(cfg, workdir: Path) -> dict:
    """The sharding layer on the card's (1, 1) mesh and, on its host, the
    dry run on the production meshes (see the module's docstring)."""
    from repro_torch.launch import mesh as mesh_mod
    kernels = _path_kernels()
    res = {"phase": "mesh", "arch": cfg.name, "layers": cfg.n_layers}
    t0 = time.perf_counter()
    started = _start_dryruns(workdir)
    try:
        with mesh_mod.process_group("nccl", 1):
            m = mesh_mod.make_mesh((1, 1), ("data", "model"),
                                   device_type="cuda")
            res["cells"], state = _mesh_cells(cfg, m, kernels)
            res["capsule"] = _mesh_capsule(cfg, m, state, workdir)
            del state
        res["card_s"] = time.perf_counter() - t0
    finally:
        for _, _, proc, _ in started:     # reaped below, or killed here
            if res.get("card_s") is None and proc.poll() is None:
                proc.kill()
    _release()
    res["dryrun"] = _finish_dryruns(started, workdir)
    res["launches"] = {"flash_attention": sum(
        row["mesh_launches"]["flash_attention"]
        for row in res["cells"].values())}
    res["seconds"] = time.perf_counter() - t0
    emit(res)
    return res


# ----------------------------------------------------------- examples
def _example(name: str):
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def example_arches() -> dict:
    """The configs the examples run: quickstart's and serve_capsule's."""
    from repro_torch.configs.base import get_arch, reduced
    return {"torch_quickstart": reduced(get_arch("granite-3-2b")),
            "torch_serve_capsule": reduced(get_arch("falcon-mamba-7b"))}


def phase_examples() -> dict:
    """``examples/torch_*.py`` at ``device="cuda"``, each passing its own
    asserts (the loss falls by 0.5 under the faulty fleet; the base
    disk's re-snapshot stores 0 new bytes; task A resumes bit for bit;
    pause and unpause keep the caches).  Every kernel counter is set to 0
    just before and read just after: quickstart's diff snapshots must
    launch ``fused_delta_tiles`` once per size bucket of its state
    (``QUICKSTART_DIFFS`` snapshots), serve_capsule's prefill ``ssm_scan``
    once per layer, and project_switch none (its one re-snapshot finds
    the base params untouched).  The kernel phases time these launches
    (path ``examples``)."""
    import torch

    from repro_torch.kernels.delta_encode.kernel import fused_delta_tiles
    kernels = {"fused_delta_tiles": fused_delta_tiles, **_path_kernels()}
    mods = {name: _example(name) for name in EXAMPLES}
    res = {"phase": "examples", "runs": {}}

    def drive():
        for name, mod in mods.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = mod.main(device="cuda")
            torch.cuda.synchronize()
            res["runs"][name] = {"wall_s": time.perf_counter() - t0}
            if name == "torch_quickstart":
                losses = [h.loss for h in out.history]
                res["runs"][name].update(
                    first_loss=losses[0], last_loss=losses[-1],
                    snapshots=len(out.snapshots.order),
                    invalid=sum(h.invalid for h in out.history))
            elif name == "torch_project_switch":
                res["runs"][name]["disks"] = [dataclasses.asdict(d)
                                              for d in out.disks()]
            else:
                res["runs"][name]["tokens"] = out.tolist()

    _, res["launches"] = _launched(kernels, drive)
    arches = example_arches()
    expected = {
        "fused_delta_tiles": QUICKSTART_DIFFS
        * len(path_launches(arches["torch_quickstart"])),
        "flash_attention": 0,
        "ssm_scan": SERVE_CAPSULE_PREFILL[2]
        * arches["torch_serve_capsule"].n_layers}
    _check_launches("examples", res["launches"], expected)
    _release()
    emit(res)
    return res


def full_width(arch: str, n_layers: int):
    """The registered config, only ``n_layers`` cut (0 keeps them all):
    ``reduced`` would also shrink d_state, dt_rank and the experts."""
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
    ap.add_argument("--moe-layers", type=int, default=0,
                    help="depth of the serve_moe phase (0: all 28 of "
                         "deepseek-moe-16b)")
    ap.add_argument("--encdec-layers", type=int, default=0,
                    help="depth of the encdec phase, encoder and decoder "
                         "each (0: all 12 of seamless-m4t-medium)")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    cfg = granite_full_width(args.layers)
    serve_cfg = granite_full_width(args.serve_layers)
    falcon = full_width("falcon-mamba-7b", args.ssm_layers)
    hymba = full_width("hymba-1.5b", args.ssm_layers)
    deepseek = full_width("deepseek-moe-16b", args.moe_layers)
    seamless = full_width(ENCDEC_ARCH, args.encdec_layers)
    families = [(full_width(arch, n), flags)
                for arch, n, flags in FAMILY_DRIVES]
    cells_cfg = granite_full_width(CELL_LAYERS)
    examples = example_arches()
    # the drives whose prefills launch each kernel: the serve drives (with
    # the launcher or not), the cells phase's prefills and serve_capsule's
    b, t = CELL_SHAPES["prefill_32k"]
    attn_paths = {
        **{name: (c, attn_groups(c, launcher)) for name, (c, launcher) in (
            ("serve", (serve_cfg, True)), ("serve_ssm", (hymba, False)),
            ("serve_moe", (deepseek, True)), ("encdec", (seamless, True)))},
        **{name: (cells_cfg, [("prefill", b, t, t, True,
                               CELL_RUNS * cells_cfg.n_layers)])
           for name in ("cells", "mesh")}}
    ssm_paths = {"serve_ssm": (falcon, prefill_calls(True)),
                 "serve_ssm_hybrid": (hymba, prefill_calls(False)),
                 "examples": (examples["torch_serve_capsule"],
                              [SERVE_CAPSULE_PREFILL])}
    # the drives whose diff snapshots launch the probe: (cfg, snapshots):
    # the train phase's inline and async-writer drives, the hybrid's, and
    # quickstart's
    probe_paths = {"train": (cfg, 2), "train_families": (families[0][0], 1),
                   "examples": (examples["torch_quickstart"],
                                QUICKSTART_DIFFS)}

    def in_tmp(phase, *a):
        workdir = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
        try:
            return phase(*a, workdir)
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
    # the train drives whose diff snapshot launches the probe
    kern = run("kernel", phase_kernel, probe_paths)
    attn = run("attn_kernel", phase_attn_kernel, attn_paths)
    tr = run("train", in_tmp, phase_train, cfg)
    up = run("train_uplink", in_tmp, phase_train_uplink, cfg,
             granite_full_width(PLANES_LAYERS))
    fam = run("train_families", phase_train_families, families)
    sv = run("serve", phase_serve, serve_cfg)
    sv_moe = run("serve_moe", phase_serve_moe, deepseek)
    en = run("encdec", phase_encdec, seamless)
    cl = run("cells", phase_cells, cells_cfg)
    ms = run("mesh", in_tmp, phase_mesh, cells_cfg)
    ssm = run("ssm_kernel", phase_ssm_kernel, ssm_paths)
    sv_ssm = run("serve_ssm", phase_serve_ssm, falcon, hymba)
    ex = run("examples", phase_examples)
    # last, as standalone users run them: outside the train launcher's
    # deterministic mode, which fills every new allocation, outputs included
    with _nondeterministic():
        dops = run("delta_ops", phase_delta_ops, cfg)
        sprint = run("sprint", phase_sprint)
    emit({"phase_seconds": seconds})
    if None in (kern, dops, sprint, attn, tr, up, fam, sv, sv_moe, en, cl,
                ms, ssm, sv_ssm, ex):
        return 0
    # the launches counted on each main path's run, against the launches
    # each kernel phase timed
    f_name, h_name, d_name = falcon.name, hymba.name, deepseek.name
    runs = {
        "flash_attention": {
            "serve": sv["launcher"]["launches"]["flash_attention"]
            + sv["engine"]["launches"]["flash_attention"],
            "serve_ssm": sv_ssm[h_name]["engine"]["launches"]
            ["flash_attention"],
            "serve_moe": sv_moe[d_name]["launcher"]["launches"]
            ["flash_attention"]
            + sv_moe[d_name]["engine"]["launches"]["flash_attention"],
            "encdec": en["serve"]["launches"]["flash_attention"],
            "cells": cl["launches"]["flash_attention"],
            "mesh": ms["launches"]["flash_attention"]},
        "ssm_scan": {
            "serve_ssm": sv_ssm[f_name]["launcher"]["launches"]["ssm_scan"]
            + sv_ssm[f_name]["engine"]["launches"]["ssm_scan"],
            "serve_ssm_hybrid": sv_ssm[h_name]["engine"]["launches"]
            ["ssm_scan"],
            "examples": ex["launches"]["ssm_scan"]}}
    for name, timed in (("flash_attention", attn["paths"]),
                        ("ssm_scan", ssm["paths"])):
        for path, n in runs[name].items():
            check(n == timed[path]["launches"],
                  f"{name}: {path} launched {n} times, "
                  f"{timed[path]['launches']} timed")

    # the probe's main paths: the diff snapshots' launches of the train,
    # train_families and examples drives (timed by the kernel phase) and
    # the uplink's, one unit's image shapes timed per unit that diffed
    snap = kern["paths"]
    probe_runs = {"train": tr["launches"], "train_families": fam["launches"],
                  "examples": ex["launches"]["fused_delta_tiles"]}
    for path, n in probe_runs.items():
        check(n == snap[path]["launches"],
              f"fused_delta_tiles: {path} launched {n} times, "
              f"{snap[path]['launches']} timed")
    unit = up["unit"]["kernel"]
    emit({"kernels": [
        _kernel_row("fused_delta_tiles", SOURCE, REPLACES,
                    sum(probe_runs.values()) + up["launches"],
                    kern["max_abs_err"], {
                        key: sum(p[key] for p in snap.values())
                        + up["diffed_units"] * unit[key]
                        for key in ("ms", "plain_ms", "bound_ms")}
                    | {"bound_by": "bytes"}),
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
