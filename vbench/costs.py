"""The yardstick: peaks, and the operations and bytes that rooflines and
``mfu`` divide by.  Frozen copies, so that a change to the program cannot
move them: a kernel's work as ``chip_smoke.py`` counts it (``attn_work``,
``ssm_work``, the delta probe's bytes) and a step's model FLOPs as
``launch/costmodel.py`` ``analytic_cost`` counts them (6 N D for training,
2 N D for inference, N the matmul parameters without the embedding
gather, plus the causal attention term), N and the layers that attend as
the configuration's family counts them (``reference/families/``), from
the blocks' counts below.

Peaks are NVIDIA's published figures for the H100 SXM (data sheet, dense,
no sparsity), which assume the card's full 700 W power limit; the result
line carries the card's ``power.limit`` beside every share.
"""
from __future__ import annotations

from vbench.reference import families

PEAK_BF16_FLOPS = 989e12       # tensor cores, bf16/fp16 dense
PEAK_FP32_FLOPS = 67e12        # float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
DELTA_TILE_BYTES = 8 * 1024 * 4  # one (8, 1024) int32 tile of the probe


# ------------------------------------------------------------- kernels
def attn_flops(b: int, h: int, t: int, s: int, hd: int, causal: bool) -> int:
    """Q.K^T and P.V, 2 operations each per (query, key) pair and head
    dim; causal query i sees keys 0 .. min(i, s - 1)."""
    if not causal:
        pairs = t * s
    elif t <= s:
        pairs = t * (t + 1) // 2
    else:
        pairs = s * (s + 1) // 2 + (t - s) * s
    return 4 * b * h * hd * pairs


def attn_work(b: int, t: int, s: int, h: int, kh: int, hd: int,
              causal: bool, esize: int) -> dict:
    """One flash-attention call: its operations, its bytes (q, k, v read
    once, o written once) and its bound in seconds, the larger of the
    operations at the bf16 peak (f32 at the float32 one) and the bytes at
    the memory rate."""
    ops = attn_flops(b, h, t, s, hd, causal)
    nbytes = esize * hd * (2 * b * h * t + 2 * b * kh * s)
    peak = PEAK_BF16_FLOPS if esize == 2 else PEAK_FP32_FLOPS
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(ops / peak, nbytes / HBM_BYTES_PER_S)}


def ssm_flops(b: int, t: int, di: int, n: int) -> int:
    """Per state element and step dt*a, exp(.)*h, (dt x)*b, +, c*h and the
    sum over N (6); per channel and step dt*x (1); all float32."""
    return 6 * b * t * di * n + b * t * di


def ssm_work(b: int, t: int, di: int, n: int, esize: int) -> dict:
    """One selective-scan call: x and dt read and y written in the input
    dtype, B, C and A read and the final state written in f32, each once;
    operations at the float32 peak."""
    nbytes = esize * 3 * b * t * di + 4 * (2 * b * t * n + di * n
                                           + b * di * n)
    ops = ssm_flops(b, t, di, n)
    return {"ops": ops, "bytes": nbytes,
            "bound_s": max(ops / PEAK_FP32_FLOPS, nbytes / HBM_BYTES_PER_S)}


def delta_work(nblk: int, changed: int) -> dict:
    """One ``fused_delta_tiles`` launch over ``nblk`` tiles of which
    ``changed`` differ: old and new read once, the changed XOR tiles and
    the bitmap written once (3N bytes where every tile changed)."""
    nbytes = (2 * nblk + changed) * DELTA_TILE_BYTES + 4 * nblk
    return {"ops": 0, "bytes": nbytes, "bound_s": nbytes / HBM_BYTES_PER_S}


# --------------------------------------------------------------- models
def head_dim(c: dict) -> int:
    return c.get("head_dim") or c["hidden_size"] // c["num_attention_heads"]


def attention_params(c: dict) -> int:
    """One attention layer's projections: q, k, v and the output."""
    d = c["hidden_size"]
    h, kh, hd = c["num_attention_heads"], c["num_key_value_heads"], head_dim(c)
    return d * h * hd + 2 * d * kh * hd + h * hd * d


def swiglu_params(c: dict, width: int) -> int:
    """One SwiGLU feed-forward of ``width``: gate, up and down."""
    return 3 * c["hidden_size"] * width


def mamba_params(c: dict) -> int:
    """One Mamba 1 mixer: in, conv, x, dt and out projections, A and D."""
    d = c["hidden_size"]
    di, n = c["mamba_expand"] * d, c["mamba_d_state"]
    r, dc = c["mamba_dt_rank"], c["mamba_d_conv"]
    return (d * 2 * di + di * dc + di * (r + 2 * n) + r * di + di * n
            + di + di * d)


def matmul_params(c: dict) -> int:
    """Parameters that take part in a matrix product per token, as the
    configuration's family counts them (``matmul_params`` of
    ``reference/families/<family>.py``): every layer's projections, of an
    MoE layer only the experts a token is routed to and the shared ones,
    and the output head; the input embedding's gather is left out."""
    return families.of(c).matmul_params(c)


def attn_fwd_flops(c: dict, t_query: int, keys_before: int) -> float:
    """Forward attention operations of ``t_query`` new positions that
    follow ``keys_before`` cached ones, causal, over every layer that
    attends (the family's ``attention_layers``)."""
    h, hd = c["num_attention_heads"], head_dim(c)
    pairs = t_query * keys_before + t_query * (t_query + 1) / 2
    return families.of(c).attention_layers(c) * 4 * h * hd * pairs


def train_flops(c: dict, batch: int, seq: int) -> float:
    """Model operations of one training unit of ``batch`` x ``seq``
    tokens: 6 N D plus forward and backward attention (3x forward)."""
    tokens = batch * seq
    return (6.0 * matmul_params(c) * tokens
            + 3.0 * batch * attn_fwd_flops(c, seq, 0))


def prefill_flops(c: dict, t: int) -> float:
    """A batch-1 prefill of ``t`` prompt tokens."""
    return 2.0 * matmul_params(c) * t + attn_fwd_flops(c, t, 0)


def decode_flops(c: dict, cached: int) -> float:
    """One decoded token after ``cached`` positions."""
    return 2.0 * matmul_params(c) + attn_fwd_flops(c, 1, cached)
