"""Activated batch normalization (the reference's InPlaceABN), NCHW.

Counterpart of `structure_knowledge_distillation_tpu/ops/batch_norm.py`. The
conventions kept for checkpoint import and numeric parity:
  * gamma = |weight| + eps (reference libs/src/bn.cu:153),
  * activation in {none, leaky_relu(slope), elu} after the affine map,
  * parameters `weight`, `bias` and buffers `running_mean`, `running_var`:
    the reference's state-dict names, with no `num_batches_tracked`;
  * train mode normalises with the biased batch variance, f32 statistics,
    and updates the running statistics with momentum 0.1 and a
    Bessel-corrected variance (reference libs/functions.py:91,209);
  * its gradient is the reference's analytic backward (`abn_train`), built
    of differentiable torch ops so that a second derivative exists (the
    discriminator's WGAN-GP differentiates through it).

`ABN(fused=True)` is the JAX package's fused path (`ABN(fused=True)`,
`ops/pallas_bn.py`): train mode through `fused_bn.abn_fused_train`, whose
forward and backward are the CUDA kernels K6–K8 on the card, differentiable
once; eval mode through `fused_bn.abn_fused_eval` (K6), which has no
gradient. The running update is the same in both paths. `BatchNorm2d` (the
discriminator's) stays unfused: the WGAN-GP differentiates it twice.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["ABN", "BatchNorm2d", "abn_normalize", "abn_train"]

ACTIVATIONS = ("none", "leaky_relu", "elu")


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


def _gamma(weight: torch.Tensor, eps: float, abs_gamma: bool) -> torch.Tensor:
    w = weight.float()
    return w.abs() + eps if abs_gamma else w


def _moments(xf: torch.Tensor):
    """Per-channel mean and biased variance over (N, H, W) of an f32 NCHW
    tensor, as E[x²] − E[x]² clamped at 0 (the JAX `_moments`)."""
    dims = [0] + list(range(2, xf.dim()))
    n = xf.numel() // xf.shape[1]
    mean = xf.sum(dims) / n
    var = torch.clamp((xf * xf).sum(dims) / n - mean * mean, min=0.0)
    return mean, var, n


def _channel_view(t: torch.Tensor, ndim: int) -> torch.Tensor:
    return t.view((1, -1) + (1,) * (ndim - 2))


def _abn_train_grads(x, weight, bias, dz, eps, activation, slope, abs_gamma):
    """The analytic backward of the JAX `abn_train` (`batch_norm.py:148-178`):

        dx = γ·invstd·(dh − edz/n − ŷ·eydz/n),
        dweight = sign(w)·eydz (γ = |w| + eps),  dbias = edz.

    Differentiable torch ops throughout, with the statistics recomputed from
    x, so that autograd can take its derivative again (the GP's double
    backward), as JAX differentiates its custom-VJP backward."""
    xf = x.float()
    mean, var, n = _moments(xf)
    inv_std = torch.rsqrt(var + eps)
    gamma = _gamma(weight, eps, abs_gamma)
    cv = lambda t: _channel_view(t, x.dim())  # noqa: E731
    y = (xf - cv(mean)) * cv(inv_std)
    dzf = dz.float()
    if activation == "none":
        dh = dzf
    else:
        h = y * cv(gamma) + cv(bias.float())
        if activation == "leaky_relu":
            dh = torch.where(h >= 0, dzf, dzf * slope)
        elif activation == "elu":
            dh = torch.where(h >= 0, dzf, dzf * torch.exp(h))
        else:
            raise ValueError(f"unknown activation {activation!r}")
    dims = [0] + list(range(2, x.dim()))
    edz = dh.sum(dims)
    eydz = (dh * y).sum(dims)
    dx = cv(gamma * inv_std) * (dh - cv(edz / n) - y * cv(eydz / n))
    dweight = (torch.sign(weight) if abs_gamma else torch.ones_like(weight)) * eydz
    return dx.to(x.dtype), dweight.to(weight.dtype), edz.to(weight.dtype)


class _ABNTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, activation, slope, abs_gamma):
        xf = x.float()
        mean, var, _ = _moments(xf)
        inv_std = torch.rsqrt(var + eps)
        scale = _gamma(weight, eps, abs_gamma) * inv_std
        shift = bias.float() - mean * scale
        h = xf * _channel_view(scale, x.dim()) + _channel_view(shift, x.dim())
        z = _apply_activation(h, activation, slope).to(x.dtype)
        ctx.save_for_backward(x, weight, bias)
        ctx.cfg = (eps, activation, slope, abs_gamma)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    def backward(ctx, dz, _dmean, _dvar):
        x, weight, bias = ctx.saved_tensors
        dx, dweight, dbias = _abn_train_grads(x, weight, bias, dz, *ctx.cfg)
        return dx, dweight, dbias, None, None, None, None


def abn_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor, eps: float,
              activation: str = "none", slope: float = 0.01, abs_gamma: bool = True):
    """Train-mode activated BN over the batch statistics of an NCHW tensor.
    Returns (z, mean, var): z in x's dtype, the f32 batch mean and biased
    variance for the running update (no gradient flows into those)."""
    return _ABNTrain.apply(x, weight, bias, eps, activation, slope, abs_gamma)


class ABN(nn.Module):
    """Activated batch norm over the channel axis (dim 1).

    Eval mode normalises with the running statistics; train mode with the
    batch statistics, and then moves the running statistics by `momentum`
    (torch convention: running = (1 − m)·running + m·batch). `fused` takes
    the fused kernels of `fused_bn` (the JAX `ABN(fused=True)`)."""

    def __init__(self, num_features: int, eps: float = 1e-5, activation: str = "none",
                 slope: float = 0.01, abs_gamma: bool = True, momentum: float = 0.1,
                 device: torch.device | str | None = None, fused: bool = False):
        super().__init__()
        if activation not in ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.num_features = num_features
        self.eps = eps
        self.activation = activation
        self.slope = slope
        self.abs_gamma = abs_gamma
        self.momentum = momentum
        self.fused = fused
        self.weight = nn.Parameter(torch.ones(num_features, device=device))
        self.bias = nn.Parameter(torch.zeros(num_features, device=device))
        self.register_buffer("running_mean", torch.zeros(num_features, device=device))
        self.register_buffer("running_var", torch.ones(num_features, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # imported here: fused_bn builds on this module's helpers
        from structure_knowledge_distillation_tpu_torch.ops import fused_bn

        if not self.training:
            if self.fused:
                return fused_bn.abn_fused_eval(x, self.weight, self.bias, self.running_mean,
                                               self.running_var, self.eps, self.activation,
                                               self.slope, self.abs_gamma)
            return abn_normalize(x, self.running_mean, self.running_var, self.weight,
                                 self.bias, eps=self.eps, activation=self.activation,
                                 slope=self.slope, abs_gamma=self.abs_gamma)
        train_fn = fused_bn.abn_fused_train if self.fused else abn_train
        z, mean, var = train_fn(x, self.weight, self.bias, self.eps, self.activation,
                                self.slope, self.abs_gamma)
        n = x.numel() // x.shape[1]
        bessel = n / max(n - 1, 1)
        m = self.momentum
        with torch.no_grad():
            self.running_mean.copy_((1 - m) * self.running_mean + m * mean)
            self.running_var.copy_((1 - m) * self.running_var + m * (var * bessel))
        return z

    def extra_repr(self) -> str:
        return (f"{self.num_features}, eps={self.eps}, activation={self.activation}, "
                f"abs_gamma={self.abs_gamma}, momentum={self.momentum}, fused={self.fused}")


class BatchNorm2d(ABN):
    """Plain torch-style BatchNorm2d: no |gamma| quirk, no activation. Used by
    the discriminator's preprocess layer (reference sagan_models.py:148)."""

    def __init__(self, num_features: int, eps: float = 1e-5, momentum: float = 0.1,
                 device: torch.device | str | None = None):
        super().__init__(num_features, eps=eps, abs_gamma=False, momentum=momentum,
                         device=device)
