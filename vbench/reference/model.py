"""The plain reference of the decoder-only families the cells run: dense
GQA (granite-3-2b) and the hybrid of parallel attention and Mamba heads
(hymba-1.5b), in float32, written from the published equations.

Weights come as {dotted name: tensor} with the program's stacked layout
(``layers.attn.wq`` is (L, d, H, hd), ``layers.ssm.conv_w`` (L, d_conv,
Di)), made by the benchmark, not by the program.  Each block is

    h = x + attn(norm1(x))                            (dense)
    h = x + (norm_a(attn(n)) + norm_s(mamba(n))) / 2  (hybrid, n = norm1(x))
    x' = h + down(silu(n2 gate) * (n2 up)),  n2 = norm2(h)

with RMS norms, rotary positions on q and k (the halves rotated), causal
softmax attention at scale 1/sqrt(hd) whose query head h reads KV head
h // (H/K), and Mamba 1's selective scan (Gu and Dao, 2023): a causal
depthwise conv, dt = softplus(x W_dt + b), A = -exp(A_log),
h_t = exp(dt A) h_{t-1} + dt x B_t, y = C_t h_t + D x, times silu(z).

The projections go through ``prec.mm``, so the control can compute them
in a lower precision (``precision.py``); everything else is float32.
TF32 is off on the card (``precision.no_tf32``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from vbench.reference.precision import Precision


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


def attention(c: dict, w: dict, i: int, x: torch.Tensor,
              prec: Precision) -> torch.Tensor:
    b, t, d = x.shape
    h, kh = c["num_attention_heads"], c["num_key_value_heads"]
    hd = c.get("head_dim") or d // h
    q = prec.mm(x, w["layers.attn.wq"][i].reshape(d, h * hd)).view(b, t, h, hd)
    k = prec.mm(x, w["layers.attn.wk"][i].reshape(d, kh * hd)).view(b, t, kh, hd)
    v = prec.mm(x, w["layers.attn.wv"][i].reshape(d, kh * hd)).view(b, t, kh, hd)
    q, k = rotary(q, c["rope_theta"]), rotary(k, c["rope_theta"])
    k = k.repeat_interleave(h // kh, dim=2)
    v = v.repeat_interleave(h // kh, dim=2)
    scores = torch.einsum("bthd,bshd->bhts", q, k) / math.sqrt(hd)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    p = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = torch.einsum("bhts,bshd->bthd", p, v).reshape(b, t, h * hd)
    return prec.mm(o, w["layers.attn.wo"][i].reshape(h * hd, d))


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
    n, r = c["mamba_d_state"], c["mamba_dt_rank"]
    xr, z = prec.mm(x, w["layers.ssm.in_proj"][i]).chunk(2, dim=-1)
    cw = w["layers.ssm.conv_w"][i]                          # (dc, Di)
    dc, t = cw.shape[0], x.shape[1]
    xp = F.pad(xr, (0, 0, dc - 1, 0))
    conv = sum(cw[j] * xp[:, j:j + t] for j in range(dc))
    xc = F.silu(conv + w["layers.ssm.conv_b"][i])
    dbc = prec.mm(xc, w["layers.ssm.x_proj"][i])
    dt, bm, cm = torch.split(dbc, [r, n, n], dim=-1)
    dt = F.softplus(prec.mm(dt, w["layers.ssm.dt_proj"][i])
                    + w["layers.ssm.dt_bias"][i])
    a = -torch.exp(w["layers.ssm.A_log"][i])
    y = selective_scan(dt, xc, bm, cm, a) + xc * w["layers.ssm.D"][i]
    return prec.mm(y * F.silu(z), w["layers.ssm.out_proj"][i])


def block(c: dict, w: dict, i: int, x: torch.Tensor,
          prec: Precision) -> torch.Tensor:
    eps = c["rms_norm_eps"]
    n = rms_norm(x, w["layers.ln1"][i], eps)
    a = attention(c, w, i, n, prec)
    if c["family"] == "hybrid":
        s = mamba(c, w, i, n, prec)
        a = 0.5 * (rms_norm(a, w["layers.norm_attn"][i], eps)
                   + rms_norm(s, w["layers.norm_ssm"][i], eps))
    x = x + a
    n2 = rms_norm(x, w["layers.ln2"][i], eps)
    hidden = F.silu(prec.mm(n2, w["layers.mlp.w_gate"][i])) \
        * prec.mm(n2, w["layers.mlp.w_up"][i])
    return x + prec.mm(hidden, w["layers.mlp.w_down"][i])


def hidden(c: dict, w: dict, tokens: torch.Tensor,
           prec: Precision) -> torch.Tensor:
    """tokens (B, T) -> final-normed hidden states (B, T, d)."""
    x = w["embed"][tokens.long()]
    for i in range(c["num_hidden_layers"]):
        x = block(c, w, i, x, prec)
    return rms_norm(x, w["final_norm"], c["rms_norm_eps"])


def logits(c: dict, w: dict, x: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Hidden states -> logits over the real vocabulary (the padded
    columns of the head left out); a tied head is the embedding's
    transpose."""
    v = c["vocab_size"]
    if c["tie_word_embeddings"]:
        return prec.mm(x, w["embed"][:v].t())
    return prec.mm(x, w["lm_head"][:, :v])


def loss(c: dict, w: dict, tokens: torch.Tensor, labels: torch.Tensor,
         prec: Precision) -> torch.Tensor:
    """Mean next-token cross-entropy over (B, T)."""
    lg = logits(c, w, hidden(c, w, tokens, prec), prec)
    return F.cross_entropy(lg.reshape(-1, lg.shape[-1]),
                           labels.long().reshape(-1))
