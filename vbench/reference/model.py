"""The plain reference's shared pieces, in float32, written from the
published equations; each family (``families/<family>.py``, found by the
configuration's ``family``) builds its blocks from them.

Weights come as {dotted name: tensor} with the program's stacked layout
(``layers.attn.wq`` is (L, d, H, hd), ``layers.ssm.conv_w`` (L, d_conv,
Di)), made by the benchmark, not by the program, in the dtype the program
holds them in (float32 in training, bfloat16 in serving).  Each weight is
upcast to float32 where it is used, before anything else touches it, one
layer's slice at a time (``layer``; one expert's, where a layer holds
experts): the upcast is exact, and no stacked leaf is ever upcast whole.

The pieces: RMS norms; rotary positions on q and k (the halves rotated);
causal softmax attention at scale 1/sqrt(hd) whose query head h reads KV
head h // (H/K), in blocks of queries whose scores take at most
``SCORE_BYTES`` (one block while all of them fit), each row's softmax
over all its keys; Mamba 1's selective scan (Gu and Dao, 2023): a causal
depthwise conv, dt = softplus(x W_dt + b), A = -exp(A_log), h_t =
exp(dt A) h_{t-1} + dt x B_t, y = C_t h_t + D x, times silu(z); the
SwiGLU feed-forward, down(silu(x gate) * (x up)).

The projections go through ``prec.mm``, so the control can compute them
in a lower precision (``precision.py``); everything else is float32.
TF32 is off on the card (``precision.no_tf32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vbench.reference import families
from vbench.reference.precision import Precision

SCORE_BYTES = 4 * 2**30     # the most scores one block of queries makes


def layer(w: dict, key: str, *index: int) -> torch.Tensor:
    """Leaf ``key``'s slice at ``index`` (a layer's; a layer's expert's),
    upcast to float32: a float32 leaf's slice is itself."""
    return w[key][index].float()


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def rotary(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, T, H, hd), positions 0 .. T-1."""
    t, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(t, dtype=torch.float32, device=x.device)[:, None] \
        * freqs[None]
    cos, sin = torch.cos(ang)[None, :, None], torch.sin(ang)[None, :, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


def causal_softmax_attention(q, k, v, score_bytes: int = SCORE_BYTES):
    """q, k, v (B, T, H, hd), K and V repeated to H heads -> (B, T, H, hd).
    The scores run in blocks of as many queries as fit in ``score_bytes``
    (all T of them while the whole (B, H, T, T) fits), each block's rows
    over the keys up to its last query."""
    b, t, h, hd = q.shape
    rows = max(1, score_bytes // (b * h * t * 4))
    keys = torch.arange(t, device=q.device)
    out = []
    for s in range(0, t, rows):
        e = min(s + rows, t)
        scores = torch.einsum("bthd,bshd->bhts", q[:, s:e], k[:, :e]) \
            / math.sqrt(hd)
        causal = keys[None, :e] <= keys[s:e, None]
        p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
        out.append(torch.einsum("bhts,bshd->bthd", p, v[:, :e]))
    return torch.cat(out, 1)


def attention(c: dict, w: dict, i: int, x: torch.Tensor, prec: Precision,
              score_bytes: int = SCORE_BYTES) -> torch.Tensor:
    """Layer ``i``'s rotary GQA attention of x (B, T, d); ``score_bytes``
    as in ``causal_softmax_attention``."""
    b, t, d = x.shape
    h, kh = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // h
    q = prec.mm(x, layer(w, "layers.attn.wq", i).reshape(d, h * hd)) \
        .view(b, t, h, hd)
    k = prec.mm(x, layer(w, "layers.attn.wk", i).reshape(d, kh * hd)) \
        .view(b, t, kh, hd)
    v = prec.mm(x, layer(w, "layers.attn.wv", i).reshape(d, kh * hd)) \
        .view(b, t, kh, hd)
    q, k = rotary(q, c["rope_theta"]), rotary(k, c["rope_theta"])
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    o = causal_softmax_attention(q, k, v, score_bytes).reshape(b, t, h * hd)
    return prec.mm(o, layer(w, "layers.attn.wo", i).reshape(h * hd, d))


def selective_scan(dt, xc, bm, cm, a, chunk: int = 32):
    """h_t = exp(dt_t a) h_{t-1} + dt_t x_t B_t, y_t = h_t . C_t, in
    chunks of ``chunk`` steps; inside a chunk each h_t is the sum over
    s <= t of exp(sum_{s<r<=t} dt_r a) dt_s x_s B_s, whose factors are at
    most 1.  dt, xc (B, T, Di); bm, cm (B, T, N); a (Di, N) -> (B, T, Di)."""
    b, t, di = xc.shape
    n = a.shape[-1]
    h = xc.new_zeros(b, di, n)
    ys = []
    for s in range(0, t, chunk):
        e = min(s + chunk, t)
        la = dt[:, s:e, :, None] * a                         # (B,c,Di,N)
        bx = (dt[:, s:e] * xc[:, s:e])[..., None] * bm[:, s:e, None, :]
        cum = la.cumsum(1)
        c_ = e - s
        lower = torch.ones(c_, c_, dtype=torch.bool, device=xc.device).tril()
        diff = cum[:, :, None] - cum[:, None, :]             # (B,t,s,Di,N)
        wts = torch.exp(diff.masked_fill(~lower[None, :, :, None, None],
                                         float("-inf")))
        hs = torch.einsum("btsdn,bsdn->btdn", wts, bx) \
            + torch.exp(cum) * h[:, None]
        ys.append(torch.einsum("btdn,btn->btd", hs, cm[:, s:e]))
        h = hs[:, -1]
    return torch.cat(ys, 1)


def mamba(c: dict, w: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    """Layer ``i``'s Mamba 1 mixer of x (B, T, d)."""
    n, r = c["mamba_d_state"], c["mamba_dt_rank"]
    xr, z = prec.mm(x, layer(w, "layers.ssm.in_proj", i)).chunk(2, dim=-1)
    cw = layer(w, "layers.ssm.conv_w", i)                   # (dc, Di)
    dc, t = cw.shape[0], x.shape[1]
    xp = F.pad(xr, (0, 0, dc - 1, 0))
    conv = sum(cw[j] * xp[:, j:j + t] for j in range(dc))
    xc = F.silu(conv + layer(w, "layers.ssm.conv_b", i))
    dbc = prec.mm(xc, layer(w, "layers.ssm.x_proj", i))
    dt, bm, cm = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(prec.mm(dt, layer(w, "layers.ssm.dt_proj", i))
                    + layer(w, "layers.ssm.dt_bias", i))
    a = -torch.exp(layer(w, "layers.ssm.A_log", i))
    y = selective_scan(dt, xc, bm, cm, a) + xc * layer(w, "layers.ssm.D", i)
    return prec.mm(y * F.silu(z), layer(w, "layers.ssm.out_proj", i))


def swiglu(w: dict, i: int, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Layer ``i``'s SwiGLU feed-forward of x (B, T, d)."""
    hidden = F.silu(prec.mm(x, layer(w, "layers.mlp.w_gate", i))) \
        * prec.mm(x, layer(w, "layers.mlp.w_up", i))
    return prec.mm(hidden, layer(w, "layers.mlp.w_down", i))


def embed(w: dict, tokens: torch.Tensor) -> torch.Tensor:
    """tokens (B, T) -> their rows of the embedding (B, T, d)."""
    return w["embed"][tokens.long()].float()


def hidden(c: dict, w: dict, tokens: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """tokens (B, T) -> final-normed hidden states (B, T, d), by the
    blocks of the configuration's family."""
    return families.of(c).hidden(c, w, tokens, prec)


def logits(c: dict, w: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Hidden states -> logits over the real vocabulary (the padded
    columns of the head left out); a tied head is the embedding's
    transpose."""
    v = c["vocab_size"]
    if c["tie_word_embeddings"]:
        return prec.mm(x, w["embed"][:v].float().t())
    return prec.mm(x, w["lm_head"].float()[:, :v])


def loss(c: dict, w: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy over (B, T)."""
    lg = logits(c, w, hidden(c, w, tokens, prec), prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.long().reshape(-1))
