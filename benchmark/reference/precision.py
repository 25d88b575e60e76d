"""Where the reference rounds: the operands and results of every convolution
and matmul.

`Exact` is the reference proper: float32 with TF32 off, nothing rounded.
`Rounded(dtype)` is the control: every convolution's and matmul's input and
weight are rounded to `dtype` before an f32 product, and so is its result,
as a network computing in `dtype` stores its activations; going back, the
gradient at each of those places is rounded too: to e5m2 where the forward
is e4m3, the usual fp8 training recipe (e4m3 activations and weights, e5m2
gradients). For float8 types
each tensor is scaled by its own absolute maximum first (per-tensor scaling,
as fp8 training recipes do), so the rounding is of the 3-bit mantissa and
not an underflow.
"""

from __future__ import annotations

import torch

__all__ = ["Exact", "Rounded", "exact_f32"]

_FP8_MAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def exact_f32() -> None:
    """The reference's arithmetic: float32 products with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


class Exact:
    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x


def _round(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    x = x.detach().float()
    top = _FP8_MAX.get(dtype)
    if top is None:
        return x.to(dtype).float()
    scale = x.abs().amax().clamp_min(1e-30) / top
    return (x / scale).to(dtype).float() * scale


class _RoundBoth(torch.autograd.Function):
    """Round the value going forward and the gradient going back."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return _round(x, fwd)

    @staticmethod
    def backward(ctx, grad):
        # differentiable in `grad` (straight through the rounding), so the
        # gradient penalty's double backward keeps its graph
        return grad + (_round(grad, ctx.bwd) - grad).detach(), None, None


class Rounded:
    """Round to `dtype` and back to float32; a tensor with a gradient has its
    gradient rounded to `grad_dtype` (default `dtype`) on the way back, as a
    network computing in that type stores its activations' gradients."""

    def __init__(self, dtype: torch.dtype, grad_dtype=None):
        self.dtype, self.grad_dtype = dtype, grad_dtype or dtype

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if not x.requires_grad:
            return _round(x, self.dtype)
        return _RoundBoth.apply(x, self.dtype, self.grad_dtype)
