"""ResNet-backbone PSPNet — teacher (R101/Bottleneck) and student (R18/Basic).

Counterpart of `structure_knowledge_distillation_tpu/models/resnet_pspnet.py`
in NCHW, with the reference's module tree (networks/pspnet_combine.py), so
its state-dict keys are the reference's torch keys:
  * 3-conv stem 3→64→64→128, first conv stride 2, then a ceil-mode 3×3/2 max
    pool: 512² crops give 65×65 stride-8 maps, 1024×2048 frames 129×257;
  * dilated layer3 (d=2) and layer4 (d=4), output stride 8;
  * PSP pyramid pooling over bins (1,2,3,6): `pspmodule.stages.i.{0 pool,
    1 conv, 2 ABN}`, then the literal concat + 3×3 conv `pspmodule.bottleneck`.
    The JAX default computes that conv in a factored form shaped for the TPU's
    matrix unit; the two agree up to float reassociation;
  * DSN auxiliary head from layer3: `dsn.{0 conv+bias, 1 ABN, 2 Dropout2d,
    3 conv+bias}`;
  * the forward contract is the 7-tuple
    (logits, dsn_logits, feat_after_psp, x4, x3, x2, x1).

`fold_bn=True` is the JAX model's folded form, for inference: every ABN is
its bare activation and every conv it followed has a bias, which holds the
eval-mode ABN folded in ahead of time (`models/fold.py`).

Train mode runs ABN on batch statistics and the two channel dropouts at
`drop_rate` (0.0 turns them off, as parity tests do: masks cannot be shared
across frameworks). `dtype` is the compute dtype of the convolutions, as in
the JAX model: with bfloat16 the input is cast once, every conv casts its f32
weights to bf16, and the activations stay bf16 between layers, while ABN
computes its statistics and normalisation in f32 and returns bf16, and the
PSP upsample interpolates in f32. Parameters and running statistics stay f32.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from structure_knowledge_distillation_tpu_torch.ops.batch_norm import ABN, running_stats_frozen
from structure_knowledge_distillation_tpu_torch.ops.pooling import AdaptiveAvgPool2d, max_pool_2d
from structure_knowledge_distillation_tpu_torch.ops.resize import (
    resize_bilinear_align_corners,
)

__all__ = [
    "ResPSPNet", "BasicBlock", "Bottleneck", "PSPModule", "Conv2d", "Dropout2d",
    "BASIC", "BOTTLENECK", "teacher_model", "student_model",
]

BASIC = "basic"
BOTTLENECK = "bottleneck"

Device = Optional[torch.device | str]
DType = Optional[torch.dtype]
Draws = Callable[[tuple], torch.Tensor]  # a uniform source: shape -> U[0, 1) f32

# PSP/DSN Dropout2d rate (reference pspnet_combine.py:100)
DROP_RATE = 0.1


def _remat_contexts():
    """`checkpoint`'s context_fn: nothing around the first forward, the
    running statistics frozen around the recompute."""
    return contextlib.nullcontext(), running_stats_frozen()


class Conv2d(nn.Conv2d):
    """`nn.Conv2d` computing in `compute_dtype` (None: as given). The
    parameters stay f32 and are cast per call, as a JAX conv with `dtype`."""

    def __init__(self, *args, compute_dtype: DType = None, **kwargs):
        super().__init__(*args, **kwargs)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if dt is None:
            return super().forward(x)
        bias = self.bias.to(dt) if self.bias is not None else None
        return F.conv2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                        self.dilation, self.groups)


class Dropout2d(nn.Module):
    """Channel dropout, as the JAX model's `nn.Dropout(broadcast_dims=(1, 2))`:
    in train mode each (sample, channel) map is kept with probability
    1 − rate and scaled by 1/(1 − rate). The mask compares U[0, 1) draws
    with 1 − rate. They come from `draws`, a callable shape -> f32 tensor
    (the train step's uniform source, `training/train_step.py`: drawn on the
    CPU from the trainer's generator, so a seed gives the same masks on
    every device, or read from a device buffer the host filled from it
    before a CUDA-graph replay); with None, from torch's default generator
    on the CPU."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        if not self.training or self.rate == 0.0:
            return x
        keep_prob = 1.0 - self.rate
        shape = tuple(x.shape[:2]) + (1,) * (x.dim() - 2)
        u = torch.rand(shape) if draws is None else draws(shape)
        keep = (u < keep_prob).to(x.device)
        return torch.where(keep, x / keep_prob, torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def _abn(features: int, activation: str = "none", device: Device = None,
         fused: bool = False, fold_bn: bool = False) -> nn.Module:
    """An ABN, or with `fold_bn` its bare activation, with no parameters or
    buffers (the JAX `_bn_factory`): identity for "none", leaky_relu(0.01)
    for "leaky_relu". `fold_bn` overrides `fused`."""
    if not fold_bn:
        return ABN(features, activation=activation, device=device, fused=fused)
    if activation == "leaky_relu":
        return nn.LeakyReLU(0.01)
    if activation != "none":
        raise ValueError(f"no folded form for activation {activation!r}")
    return nn.Identity()


def _conv(cin: int, cout: int, kernel: int, stride: int = 1, dilation: int = 1,
          bias: bool = False, device: Device = None, dtype: DType = None) -> Conv2d:
    return Conv2d(cin, cout, kernel, stride=stride,
                  padding=dilation * (kernel - 1) // 2, dilation=dilation,
                  bias=bias, device=device, compute_dtype=dtype)


class BasicBlock(nn.Module):
    """Two 3×3 convs + identity (reference pspnet_combine.py:19-45)."""

    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 device: Device = None, dtype: DType = None, bn_fused: bool = False,
                 fold_bn: bool = False):
        super().__init__()
        conv = lambda *a: _conv(*a, bias=fold_bn, device=device, dtype=dtype)  # noqa: E731
        bn = lambda c: _abn(c, device=device, fused=bn_fused, fold_bn=fold_bn)  # noqa: E731
        self.conv1 = conv(inplanes, planes, 3, stride, dilation)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, 1, dilation)
        self.bn2 = bn(planes)
        self.downsample = (nn.Sequential(conv(inplanes, planes, 1, stride), bn(planes))
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + residual)


class Bottleneck(nn.Module):
    """1×1 → 3×3 → 1×1(×4) bottleneck (reference pspnet_combine.py:47-84)."""

    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1,
                 dilation: int = 1, has_downsample: bool = False,
                 device: Device = None, dtype: DType = None, bn_fused: bool = False,
                 fold_bn: bool = False):
        super().__init__()
        conv = lambda *a: _conv(*a, bias=fold_bn, device=device, dtype=dtype)  # noqa: E731
        bn = lambda c: _abn(c, device=device, fused=bn_fused, fold_bn=fold_bn)  # noqa: E731
        self.conv1 = conv(inplanes, planes, 1)
        self.bn1 = bn(planes)
        self.conv2 = conv(planes, planes, 3, stride, dilation)
        self.bn2 = bn(planes)
        self.conv3 = conv(planes, planes * 4, 1)
        self.bn3 = bn(planes * 4)
        self.downsample = (nn.Sequential(conv(inplanes, planes * 4, 1, stride), bn(planes * 4))
                           if has_downsample else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        residual = self.downsample(x) if self.downsample is not None else x
        return F.relu(out + residual)


class PSPModule(nn.Module):
    """Pyramid scene parsing pooling head (reference pspnet_combine.py:86-112).

    Each level is adaptive-avg-pool → 1×1 conv → ABN(leaky_relu) →
    align-corners upsample back; the levels are concatenated before the input
    and bottlenecked by a 3×3 conv + ABN(leaky_relu) + Dropout2d.
    """

    def __init__(self, in_features: int, out_features: int = 512,
                 sizes: Sequence[int] = (1, 2, 3, 6), device: Device = None,
                 dtype: DType = None, drop_rate: float = DROP_RATE, bn_fused: bool = False,
                 fold_bn: bool = False):
        super().__init__()
        conv = lambda *a: _conv(*a, bias=fold_bn, device=device, dtype=dtype)  # noqa: E731
        bn = lambda: _abn(out_features, "leaky_relu", device, bn_fused, fold_bn)  # noqa: E731
        self.stages = nn.ModuleList([
            nn.Sequential(AdaptiveAvgPool2d((s, s)), conv(in_features, out_features, 1), bn())
            for s in sizes
        ])
        self.bottleneck = nn.Sequential(
            conv(in_features + len(sizes) * out_features, out_features, 3),
            bn(),
            Dropout2d(drop_rate),
        )

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None) -> torch.Tensor:
        h, w = x.shape[2], x.shape[3]
        priors = [resize_bilinear_align_corners(stage(x), (h, w)) for stage in self.stages]
        conv, bn, dropout = self.bottleneck
        return dropout(bn(conv(torch.cat(priors + [x], dim=1))), draws)


class ResPSPNet(nn.Module):
    """The combined backbone + PSP + DSN network (reference Res_pspnet).

    block: "bottleneck" (teacher, layers [3,4,23,3]) or "basic" (student,
    layers [2,2,2,2]). `width_mult` scales the stem, residual, DSN and PSP
    widths (the heads stay at num_classes); 1.0 is the reference geometry.
    Convolution weights are drawn from `generator` (He normal, fan-out, as the
    JAX package initialises them) on the CPU and copied to `device`, so a seed
    gives the same weights on every device; biases start at 0. `dtype` is the
    convolutions' compute dtype (None: float32) and `drop_rate` the rate of
    the PSP and DSN channel dropouts in train mode. `bn_fused` makes every
    ABN the fused one (`ABN(fused=True)`, kernels K6–K8), as the JAX model's
    `bn_fused`. `remat` runs each residual block under a non-reentrant
    `torch.utils.checkpoint` in train mode with gradients on (the JAX
    model's `nn.remat` of its block class): the backward recomputes the
    block's forward instead of keeping its activations, and the recompute
    leaves the running statistics alone (`running_stats_frozen`), so they
    move once per step, as JAX's functional batch_stats do. Neither option
    changes the state-dict keys. `fold_bn` (eval only, the JAX model's
    `fold_bn`) makes every ABN its bare activation and gives each conv it
    followed a bias: the keys are then those that
    `models.fold.fold_bn_state_dict` returns. It overrides `bn_fused`.
    """

    def __init__(self, block: str = BOTTLENECK, layers: Sequence[int] = (3, 4, 23, 3),
                 num_classes: int = 19, width_mult: float = 1.0, device: Device = None,
                 generator: Optional[torch.Generator] = None, dtype: DType = None,
                 drop_rate: float = DROP_RATE, bn_fused: bool = False, remat: bool = False,
                 fold_bn: bool = False):
        super().__init__()
        if block not in (BASIC, BOTTLENECK):
            raise ValueError(f"unknown block {block!r}")
        self.block = block
        self.dtype = dtype
        self.remat = remat
        block_cls = Bottleneck if block == BOTTLENECK else BasicBlock
        expansion = block_cls.expansion
        wm = lambda c: max(1, int(round(c * width_mult)))  # noqa: E731

        conv = lambda *a: _conv(*a, bias=fold_bn, device=device, dtype=dtype)  # noqa: E731
        bn = lambda c, act="none": _abn(c, act, device, bn_fused, fold_bn)  # noqa: E731
        self.conv1 = conv(3, wm(64), 3, 2)
        self.bn1 = bn(wm(64))
        self.conv2 = conv(wm(64), wm(64), 3)
        self.bn2 = bn(wm(64))
        self.conv3 = conv(wm(64), wm(128), 3)
        self.bn3 = bn(wm(128))

        inplanes = wm(128)
        plan = [(wm(64), 1, 1), (wm(128), 2, 1), (wm(256), 1, 2), (wm(512), 1, 4)]
        for li, ((planes, stride, dilation), blocks) in enumerate(zip(plan, layers), start=1):
            stage = []
            for bi in range(blocks):
                has_down = bi == 0 and (stride != 1 or inplanes != planes * expansion)
                stage.append(block_cls(inplanes, planes, stride if bi == 0 else 1,
                                       dilation, has_downsample=has_down, device=device,
                                       dtype=dtype, bn_fused=bn_fused, fold_bn=fold_bn))
                inplanes = planes * expansion
            setattr(self, f"layer{li}", nn.Sequential(*stage))

        c3 = plan[2][0] * expansion
        c4 = plan[3][0] * expansion
        mid = wm(512) if block == BOTTLENECK else wm(128)
        self.pspmodule = PSPModule(c4, mid, device=device, dtype=dtype, drop_rate=drop_rate,
                                   bn_fused=bn_fused, fold_bn=fold_bn)
        self.head = _conv(mid, num_classes, 1, bias=True, device=device, dtype=dtype)
        self.dsn = nn.Sequential(
            _conv(c3, mid, 3, bias=True, device=device, dtype=dtype),
            bn(mid, "leaky_relu"),
            Dropout2d(drop_rate),
            _conv(mid, num_classes, 1, bias=True, device=device, dtype=dtype),
        )
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(2.0 / fan_out))
                if m.bias is not None:
                    m.bias.zero_()

    def _stage(self, stage: nn.Sequential, x: torch.Tensor) -> torch.Tensor:
        if not (self.remat and self.training and torch.is_grad_enabled()):
            return stage(x)
        for block in stage:
            # the blocks draw no random numbers: no RNG state to keep
            x = checkpoint(block, x, use_reentrant=False, preserve_rng_state=False,
                           context_fn=_remat_contexts)
        return x

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        """The 7-tuple; `draws` is the train-mode dropout's uniform source
        (see `Dropout2d`)."""
        if self.dtype is not None:
            x = x.to(self.dtype)
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        x = F.relu(self.bn3(self.conv3(x)))
        x = max_pool_2d(x, (3, 3), (2, 2), (1, 1), ceil_mode=True)
        x1 = self._stage(self.layer1, x)
        x2 = self._stage(self.layer2, x1)
        x3 = self._stage(self.layer3, x2)
        x4 = self._stage(self.layer4, x3)
        conv1, bn, dropout, conv2 = self.dsn
        x_dsn = conv2(dropout(bn(conv1(x3)), draws))
        feat_after_psp = self.pspmodule(x4, draws)
        logits = self.head(feat_after_psp)
        return (logits, x_dsn, feat_after_psp, x4, x3, x2, x1)


def teacher_model(num_classes: int = 19, device: Device = None,
                  generator: Optional[torch.Generator] = None,
                  dtype: DType = None) -> ResPSPNet:
    return ResPSPNet(BOTTLENECK, (3, 4, 23, 3), num_classes, device=device,
                     generator=generator, dtype=dtype)


def student_model(num_classes: int = 19, device: Device = None,
                  generator: Optional[torch.Generator] = None,
                  dtype: DType = None) -> ResPSPNet:
    return ResPSPNet(BASIC, (2, 2, 2, 2), num_classes, device=device,
                     generator=generator, dtype=dtype)
