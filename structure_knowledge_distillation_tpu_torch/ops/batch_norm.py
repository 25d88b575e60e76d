"""Activated batch normalization (the reference's InPlaceABN), NCHW.

Counterpart of `structure_knowledge_distillation_tpu/ops/batch_norm.py`. The
conventions kept for checkpoint import and numeric parity:
  * gamma = |weight| + eps (reference libs/src/bn.cu:153),
  * activation in {none, leaky_relu(slope), elu} after the affine map,
  * parameters `weight`, `bias` and buffers `running_mean`, `running_var`:
    the reference's state-dict names, with no `num_batches_tracked`.

Only eval mode (running statistics) is ported. Train mode — batch statistics,
the Bessel-corrected running update and the analytic backward of `abn_train`
— is ROADMAP Queue A item "train step" and raises until then.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ABN", "BatchNorm2d", "abn_normalize"]

ACTIVATIONS = ("none", "leaky_relu", "elu")

TRAIN_MODE_ITEM = ("ABN train mode (batch statistics, running update, analytic "
                   "backward) is ROADMAP Queue A item 'train step'")


def _apply_activation(x: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == "none":
        return x
    if activation == "leaky_relu":
        return F.leaky_relu(x, slope)
    if activation == "elu":
        return F.elu(x)
    raise ValueError(f"unknown activation {activation!r}")


def abn_normalize(
    x: torch.Tensor,
    mean: torch.Tensor,
    var: torch.Tensor,
    weight: torch.Tensor,
    bias: torch.Tensor,
    *,
    eps: float,
    activation: str = "none",
    slope: float = 0.01,
    abs_gamma: bool = True,
) -> torch.Tensor:
    """Normalize + affine + activation over dim 1 of an NCHW tensor, f32 math."""
    inv_std = torch.rsqrt(var.float() + eps)
    gamma = weight.float().abs() + eps if abs_gamma else weight.float()
    scale = gamma * inv_std
    view = (1, -1) + (1,) * (x.dim() - 2)
    y = (x.float() - mean.float().view(view)) * scale.view(view) + bias.float().view(view)
    return _apply_activation(y, activation, slope).to(x.dtype)


class ABN(nn.Module):
    """Activated batch norm over the channel axis (dim 1), eval mode."""

    def __init__(self, num_features: int, eps: float = 1e-5, activation: str = "none",
                 slope: float = 0.01, abs_gamma: bool = True,
                 device: torch.device | str | None = None):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.num_features = num_features
        self.eps = eps
        self.activation = activation
        self.slope = slope
        self.abs_gamma = abs_gamma
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(TRAIN_MODE_ITEM)
        return abn_normalize(x, self.running_mean, self.running_var, self.weight,
                             self.bias, eps=self.eps, activation=self.activation,
                             slope=self.slope, abs_gamma=self.abs_gamma)

    def extra_repr(self) -> str:
        return (f"{self.num_features}, eps={self.eps}, activation={self.activation}, "
                f"abs_gamma={self.abs_gamma}")


class BatchNorm2d(ABN):
    """Plain torch-style BatchNorm2d: no |gamma| quirk, no activation. Used by
    the discriminator's preprocess layer (reference sagan_models.py:148)."""

    def __init__(self, num_features: int, eps: float = 1e-5,
                 device: torch.device | str | None = None):
        super().__init__(num_features, eps=eps, abs_gamma=False, device=device)
