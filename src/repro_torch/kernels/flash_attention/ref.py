"""Plain PyTorch version of the flash-attention kernel
(``repro.kernels.flash_attention.ref.attention_ref``)."""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True) -> torch.Tensor:
    """q: (B,H,T,hd); k,v: (B,K,S,hd).  Naive full softmax in float32;
    query head h reads KV head h // (H/K); the causal mask counts q and k
    from position 0.  Returns q's dtype."""
    b, h, t, hd = q.shape
    rep = h // k.shape[1]
    k = torch.repeat_interleave(k, rep, dim=1)
    v = torch.repeat_interleave(v, rep, dim=1)
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) / math.sqrt(hd)
    if causal:
        tq = torch.arange(t, device=q.device)[:, None]
        ts = torch.arange(k.shape[2], device=q.device)[None, :]
        s = torch.where(ts <= tq, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)
