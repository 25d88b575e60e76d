"""Fused activated batch norm: forward and backward kernels (K6–K8).

Counterpart of `structure_knowledge_distillation_tpu/ops/pallas_bn.py`, the
JAX package's `ABN(fused=True)` path (reference libs/src/bn.cu). Over NCHW
tensors, channel axis dim 1:

  * the batch statistics are plain f32 torch reductions, E[x²] − E[x]²
    clamped at 0 and biased (pallas_bn.py:203-210); scale = γ·rsqrt(var+eps)
    and shift = β − mean·scale with γ = |w| + eps (:213-221);
  * `bn_act` (K6) is z = act(x·scale + shift), f32 math, z in x's dtype; it
    serves train mode and eval mode, where scale and shift come from the
    running statistics (:268-279);
  * the backward keeps the output z, not x (:224-229), and recovers ŷ from
    it by inverting the activation by the sign of z (:101-112):
    `bn_grad_sums` (K7) gives Σg' and Σg'·ŷ per channel, and `bn_grad_input`
    (K8) dx = (g' − edz − ŷ·eydz)·γ·invstd with edz, eydz the sums over the
    count (:250-254), in dz's dtype; dweight = Σg'·ŷ·sign(w), dbias = Σg'.

The JAX backward is a Pallas kernel with no derivative of its own, so
`abn_fused_train`'s backward is `once_differentiable`: a second derivative
raises. `abn_fused_eval` has no gradient at all and raises if asked for one.

Each kernel wrapper takes its `*_plain` version on a CPU tensor and launches
the hand-written CUDA kernel of `csrc/fused_bn.cu` on a CUDA tensor, or
raises; `.launches` counts the kernel launches.
"""

from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
    ACTIVATIONS,
    _channel_view,
    _gamma,
    _moments,
)

__all__ = [
    "abn_fused_train",
    "abn_fused_eval",
    "bn_act",
    "bn_act_plain",
    "bn_grad_sums",
    "bn_grad_sums_plain",
    "bn_grad_input",
    "bn_grad_input_plain",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ACT_CODES = {"none": 0, "leaky_relu": 1, "elu": 2}
_VEC_PER_THREAD = 4  # csrc/fused_bn.cu kVecPerThread
_MAX_THREADS = 256


# ------------------------------------------------------------ plain versions
def _act(h: torch.Tensor, activation: str, slope: float) -> torch.Tensor:
    if activation == "leaky_relu":
        return torch.where(h >= 0, h, h * slope)
    if activation == "elu":
        return torch.where(h >= 0, h, torch.expm1(h))
    return h


def _invert_act(z: torch.Tensor, g: torch.Tensor, activation: str, slope: float):
    """(pre-activation, g·act'(pre)) from the output z, by the sign of z."""
    if activation == "leaky_relu":
        return torch.where(z >= 0, z, z / slope), torch.where(z >= 0, g, g * slope)
    if activation == "elu":
        return torch.where(z >= 0, z, torch.log1p(z)), torch.where(z >= 0, g, g * (z + 1.0))
    return z, g


def bn_act_plain(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                 activation: str = "none", slope: float = 0.01) -> torch.Tensor:
    """The plain version of K6: act(x·scale + shift) in f32, in x's dtype."""
    cv = lambda t: _channel_view(t, x.dim())  # noqa: E731
    return _act(x.float() * cv(scale) + cv(shift), activation, slope).to(x.dtype)


def bn_grad_sums_plain(z: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, activation: str = "none", slope: float = 0.01):
    """The plain version of K7: per-channel (Σg', Σg'·ŷ), f32."""
    cv = lambda t: _channel_view(t, z.dim())  # noqa: E731
    pre, g = _invert_act(z.float(), dz.float(), activation, slope)
    y = (pre - cv(beta)) / cv(gamma)
    dims = [0] + list(range(2, z.dim()))
    return g.sum(dims), (g * y).sum(dims)


def bn_grad_input_plain(z: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, coef: torch.Tensor, edz: torch.Tensor,
                        eydz: torch.Tensor, activation: str = "none", slope: float = 0.01,
                        training: bool = True) -> torch.Tensor:
    """The plain version of K8: (g' − edz − ŷ·eydz)·coef, or g'·coef when not
    training, f32 math, in dz's dtype."""
    cv = lambda t: _channel_view(t, z.dim())  # noqa: E731
    pre, g = _invert_act(z.float(), dz.float(), activation, slope)
    if training:
        y = (pre - cv(beta)) / cv(gamma)
        dx = (g - cv(edz) - y * cv(eydz)) * cv(coef)
    else:
        dx = g * cv(coef)
    return dx.to(dz.dtype)


# ------------------------------------------------------------------ kernels
def _check(tensors, channels, activation: str) -> None:
    x = tensors[0]
    if x.dim() < 2:
        raise ValueError(f"expected an (N, C, ...) tensor, got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"expected float32 or bfloat16, got {x.dtype}")
    for t in tensors[1:]:
        if t.shape != x.shape or t.dtype != x.dtype or t.device != x.device:
            raise ValueError("the tensors must agree in shape, dtype and device")
    for t in channels:
        if t.shape != (x.shape[1],) or t.device != x.device:
            raise ValueError(f"per-channel parameters must be ({x.shape[1]},) on {x.device}")
    if activation not in ACTIVATIONS:
        raise ValueError(f"unknown activation {activation!r}")
    if x.numel() == 0:
        raise ValueError(f"empty input {tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no fused ABN kernel for device {x.device}")


def _plane_geometry(x: torch.Tensor):
    """(n, c, hw, threads, chunks): one block row per (image, channel) plane,
    `threads` a multiple of 32 up to 256, `chunks` blocks along a plane, each
    taking threads·_VEC_PER_THREAD 16-byte vectors."""
    n, c = x.shape[0], x.shape[1]
    hw = x.numel() // (n * c)
    vecs = -(-hw * x.element_size() // 16)
    threads = min(_MAX_THREADS, 32 * -(-vecs // 32))
    chunks = -(-vecs // (threads * _VEC_PER_THREAD))
    return n, c, hw, threads, chunks


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """t as a contiguous tensor whose data starts on a 16-byte boundary: the
    kernels read 16-byte vectors. A fresh allocation always does; a view at
    an odd offset is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to(torch.float32).contiguous()


def _stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {err}")


def bn_act(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
           activation: str = "none", slope: float = 0.01) -> torch.Tensor:
    """K6: z = act(x·scale + shift) over dim 1 of an (N, C, ...) tensor, f32
    math, z in x's dtype; scale and shift are (C,) float32."""
    _check((x,), (scale, shift), activation)
    if x.device.type == "cpu":
        return bn_act_plain(x, scale.float(), shift.float(), activation, slope)
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    x = _aligned(x.detach())
    n, c, hw, threads, chunks = _plane_geometry(x)
    scale, shift = _f32(scale), _f32(shift)
    z = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.skd_bn_fwd(x.data_ptr(), scale.data_ptr(), shift.data_ptr(), z.data_ptr(),
                             _DTYPE_CODES[x.dtype], _ACT_CODES[activation], n, c, hw,
                             float(slope), threads, chunks, _stream(x.device))
    _raise_on(err, "fused ABN forward")
    bn_act.launches += 1
    return z


def bn_grad_sums(z: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                 activation: str = "none", slope: float = 0.01):
    """K7: per-channel (Σg', Σg'·ŷ) as two (C,) float32 tensors, with ŷ and
    g' = dz·act'(pre) recovered from the saved output z."""
    _check((z, dz), (gamma, beta), activation)
    if z.device.type == "cpu":
        return bn_grad_sums_plain(z, dz, gamma.float(), beta.float(), activation, slope)
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    z, dz = _aligned(z.detach()), _aligned(dz.detach())
    n, c, hw, threads, chunks = _plane_geometry(z)
    gamma, beta = _f32(gamma), _f32(beta)
    partials = torch.empty((2, c, n * chunks), dtype=torch.float32, device=z.device)
    sums = torch.empty((2, c), dtype=torch.float32, device=z.device)
    with torch.cuda.device(z.device):
        err = lib.skd_bn_sums(z.data_ptr(), dz.data_ptr(), gamma.data_ptr(), beta.data_ptr(),
                              partials.data_ptr(), sums[0].data_ptr(), sums[1].data_ptr(),
                              _DTYPE_CODES[z.dtype], _ACT_CODES[activation], n, c, hw,
                              float(slope), threads, chunks, _stream(z.device))
    _raise_on(err, "fused ABN gradient sums")
    bn_grad_sums.launches += 1
    return sums[0], sums[1]


def bn_grad_input(z: torch.Tensor, dz: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                  coef: torch.Tensor, edz: torch.Tensor, eydz: torch.Tensor,
                  activation: str = "none", slope: float = 0.01,
                  training: bool = True) -> torch.Tensor:
    """K8: dx = (g' − edz − ŷ·eydz)·coef (training) or g'·coef, in dz's
    dtype; the per-channel tensors are (C,) float32, edz and eydz the means."""
    _check((z, dz), (gamma, beta, coef, edz, eydz), activation)
    if z.device.type == "cpu":
        return bn_grad_input_plain(z, dz, gamma.float(), beta.float(), coef.float(),
                                   edz.float(), eydz.float(), activation, slope, training)
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    z, dz = _aligned(z.detach()), _aligned(dz.detach())
    n, c, hw, threads, chunks = _plane_geometry(z)
    prm = [_f32(t) for t in (gamma, beta, coef, edz, eydz)]
    dx = torch.empty_like(dz)
    with torch.cuda.device(z.device):
        err = lib.skd_bn_bwd(z.data_ptr(), dz.data_ptr(), *(t.data_ptr() for t in prm),
                             dx.data_ptr(), _DTYPE_CODES[z.dtype], _ACT_CODES[activation],
                             int(bool(training)), n, c, hw, float(slope), threads, chunks,
                             _stream(z.device))
    _raise_on(err, "fused ABN backward")
    bn_grad_input.launches += 1
    return dx


for _fn in (bn_act, bn_grad_sums, bn_grad_input):
    _fn.launches = 0


# --------------------------------------------------------------- public ops
def _scale_shift(mean, var, weight, bias, eps, abs_gamma):
    gamma = _gamma(weight, eps, abs_gamma)
    scale = gamma * torch.rsqrt(var.float() + eps)
    return gamma, scale, bias.float() - mean.float() * scale


class _ABNFusedTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, weight, bias, eps, activation, slope, abs_gamma):
        mean, var, _ = _moments(x.float())
        _, scale, shift = _scale_shift(mean, var, weight, bias, eps, abs_gamma)
        z = bn_act(x, scale, shift, activation, slope)
        ctx.save_for_backward(z, var, weight, bias)
        ctx.cfg = (eps, activation, slope, abs_gamma)
        ctx.mark_non_differentiable(mean, var)
        return z, mean, var

    @staticmethod
    @once_differentiable
    def backward(ctx, dz, _dmean, _dvar):
        z, var, weight, bias = ctx.saved_tensors
        eps, activation, slope, abs_gamma = ctx.cfg
        gamma = _gamma(weight, eps, abs_gamma)
        beta = bias.float()
        sum_g, sum_gy = bn_grad_sums(z, dz, gamma, beta, activation, slope)
        n = z.numel() // z.shape[1]
        coef = gamma * torch.rsqrt(var + eps)
        dx = bn_grad_input(z, dz, gamma, beta, coef, sum_g / n, sum_gy / n, activation, slope,
                           training=True)
        dweight = sum_gy * torch.sign(weight) if abs_gamma else sum_gy
        return dx, dweight.to(weight.dtype), sum_g.to(bias.dtype), None, None, None, None


def abn_fused_train(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                    eps: float = 1e-5, activation: str = "leaky_relu", slope: float = 0.01,
                    abs_gamma: bool = True):
    """Fused train-mode ABN over dim 1: returns (z, batch mean, biased batch
    variance); z in x's dtype, the statistics f32 with no gradient. The
    running-statistics update is the caller's job (reference
    libs/functions.py:207-209). Differentiable once."""
    return _ABNFusedTrain.apply(x, weight, bias, eps, activation, slope, abs_gamma)


def abn_fused_eval(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
                   mean: torch.Tensor, var: torch.Tensor, eps: float = 1e-5,
                   activation: str = "leaky_relu", slope: float = 0.01,
                   abs_gamma: bool = True) -> torch.Tensor:
    """Fused eval-mode ABN with frozen statistics: act(x·scale + shift), with
    scale and shift from the running statistics. It has no gradient, and
    raises where autograd would record one (call it under torch.no_grad(),
    as the frozen teacher and the eval sweep do)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, weight, bias, mean, var)):
        raise RuntimeError("abn_fused_eval has no gradient: call it under torch.no_grad() "
                           "or on tensors that do not require grad")
    _, scale, shift = _scale_shift(mean, var, weight, bias, eps, abs_gamma)
    return bn_act(x, scale, shift, activation, slope)
