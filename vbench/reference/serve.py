"""The reference of a serving cell: one full forward pass over a request's
prompt and the tokens it was served, in float32 from the served weights
(each upcast where it is used, ``model.layer``), and how far below the
reference's best logit each served token lies.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

from vbench.reference import model
from vbench.reference.precision import F32, Precision


@torch.inference_mode()
def gaps(c: dict, w: Dict[str, torch.Tensor], prompt: Sequence[int],
         served: Sequence[int], control: Optional[Precision] = None) -> dict:
    """For the served token at each position, the reference's best logit
    there minus the reference's logit of that token (0 where the served
    token is the reference's first choice).  With ``control``, the same
    gap for the token that ``control``'s forward pass puts first at each
    position, over the same prompt and served tokens."""
    dev = w["embed"].device
    seq = torch.as_tensor(list(prompt) + list(served[:-1]), device=dev)
    n, first = len(served), len(prompt) - 1
    ref = model.logits(c, w, model.hidden(c, w, seq[None], F32)[0,
                       first:first + n], F32)
    best = ref.max(-1).values
    rows = torch.arange(n, device=dev)
    out = {"served": (best - ref[rows, torch.as_tensor(list(served),
                                                       device=dev)]).tolist()}
    if control is not None:
        lc = model.logits(c, w, model.hidden(c, w, seq[None], control)[0,
                          first:first + n], control)
        out["control"] = (best - ref[rows, lc.argmax(-1)]).tolist()
    return out
