"""The precision the reference computes its projections in.

``F32`` is the reference itself: float32 products, TF32 off.  ``FP8`` is
the control: both operands of every projection rounded to float8 e4m3
with one scale per tensor (its largest magnitude at 448, e4m3's largest
finite value), the product then taken in float32.  That is the step below
the configurations' bfloat16 that a later change would be tempted to
take.  In training the backward products are rounded alike: the incoming
gradient and the saved operands, each to e4m3 under its own scale.
"""
from __future__ import annotations

import contextlib
from dataclasses import dataclass

import torch

E4M3_MAX = 448.0


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 under a per-tensor scale, back in x's dtype."""
    scale = x.abs().amax().clamp(min=1e-30) / E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale


class Fp8Mm(torch.autograd.Function):
    """a (..., k) @ b (k, n) with both operands rounded to e4m3, and in
    the backward the incoming gradient too."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = fp8_round(a), fp8_round(b)
        ctx.save_for_backward(qa, qb)
        return qa @ qb

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fp8_round(g)
        ga = qg @ qb.t()
        gb = qa.reshape(-1, qa.shape[-1]).t() @ qg.reshape(-1, qg.shape[-1])
        return ga, gb


@dataclass(frozen=True)
class Precision:
    name: str

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.name == "fp8":
            return Fp8Mm.apply(a, b)
        return a @ b


F32 = Precision("f32")
FP8 = Precision("fp8")


@contextlib.contextmanager
def no_tf32():
    """float32 products in float32: TF32 off for matmul and cuDNN."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
