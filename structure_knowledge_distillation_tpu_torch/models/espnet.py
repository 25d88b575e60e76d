"""ESPNet-C student (Mehta et al., ECCV'18), NCHW.

Counterpart of `structure_knowledge_distillation_tpu/models/espnet.py`: the
CamVid student of the reference's README rows. Efficient spatial pyramid
(ESP) modules — a reduction conv, K = 5 parallel dilated 3×3 convs
(d = 1, 2, 4, 8, 16) and hierarchical feature fusion (HFF) — with input
reinforcement at each downsampling level, activated BN (`ABN`, activation
none) and PReLU.

The module tree carries the JAX package's module names (`level1.conv`,
`level2_down.spp_0`, `br3.bn`, `classifier`, …), so its state-dict keys are
the flax paths joined by dots (`training/checkpoint.py::
espnet_state_dict_from_jax` maps a JAX variable tree onto them). The
reference has no ESPNet checkpoint, so these keys are the port's own.

The forward returns the KD 7-tuple (logits, aux, feat, l3c, l2c, l1c, l1):
stride-8 logits from `l3c`, the auxiliary head at stride 4 from `l2c`, and
the pre-classifier feature at index 2. `dtype` is the convolutions' compute
dtype, as in `ResPSPNet`: the input is cast once, weights are cast per call,
ABN computes in f32 and returns the activations' dtype, and the input
reinforcement pools in that dtype as the JAX model does.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.models.resnet_pspnet import (
    Conv2d,
    Device,
    DType,
    Draws,
    _conv,
)
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import ABN

__all__ = ["ESPNetC", "ESP", "CBR", "BR", "PReLU"]


class PReLU(nn.Module):
    """Per-channel PReLU, `where(x >= 0, x, x · alpha)` with alpha cast to
    the activations' dtype (the JAX `PReLU`); alpha starts at 0.25."""

    def __init__(self, channels: int, device: Device = None):
        super().__init__()
        self.alpha = nn.Parameter(torch.full((channels,), 0.25, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        alpha = self.alpha.to(x.dtype).view(1, -1, 1, 1)
        return torch.where(x >= 0, x, x * alpha)


class BR(nn.Module):
    """ABN (no activation) then PReLU."""

    def __init__(self, channels: int, device: Device = None):
        super().__init__()
        self.bn = ABN(channels, device=device)
        self.act = PReLU(channels, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(x))


class CBR(nn.Module):
    """Conv (no bias), ABN (no activation), PReLU."""

    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 device: Device = None, dtype: DType = None):
        super().__init__()
        self.conv = _conv(cin, cout, kernel, stride, device=device, dtype=dtype)
        self.bn = ABN(cout, device=device)
        self.act = PReLU(cout, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(x)))


class ESP(nn.Module):
    """Efficient spatial pyramid block with hierarchical feature fusion.

    The K branch widths are d1 = features − (K−1)·d and d = features // K
    (the first branch takes the remainder); the reduction conv (1×1, or 3×3
    stride 2 when downsampling) makes d1 channels, which every dilated
    branch reads. HFF adds each fused level to the next branch, the last
    channels of the previous level where the widths differ. The residual
    applies when the block keeps the input's shape."""

    def __init__(self, cin: int, features: int, stride: int = 1,
                 dilations: Sequence[int] = (1, 2, 4, 8, 16), add_residual: bool = True,
                 device: Device = None, dtype: DType = None):
        super().__init__()
        k = len(dilations)
        d = features // k
        d1 = features - d * (k - 1)
        self.widths = [d1] + [d] * (k - 1)
        self.stride = stride
        self.add_residual = add_residual
        self.reduce = _conv(cin, d1, 3 if stride == 2 else 1, stride, device=device, dtype=dtype)
        for i, dil in enumerate(dilations):
            self.add_module(f"spp_{i}", _conv(d1, self.widths[i], 3, 1, dil, device=device,
                                              dtype=dtype))
        self.bn = ABN(features, device=device)
        self.act = PReLU(features, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        reduced = self.reduce(x)
        fused = [self.spp_0(reduced)]
        for i in range(1, len(self.widths)):
            prev = fused[-1]
            add = prev[:, -self.widths[i]:] if prev.shape[1] != self.widths[i] else prev
            fused.append(getattr(self, f"spp_{i}")(reduced) + add)
        out = torch.cat(fused, dim=1)
        if self.add_residual and self.stride == 1 and out.shape == x.shape:
            out = out + x
        return self.act(self.bn(out))


def downsample_input(x: torch.Tensor, times: int) -> torch.Tensor:
    """Input reinforcement: `times` 3×3 stride-2 average pools over a zero
    padding of 1, dividing by 9 everywhere (the JAX `_downsample_input`'s
    window sum / 9), in x's dtype."""
    for _ in range(times):
        x = F.avg_pool2d(x, 3, 2, 1, count_include_pad=True)
    return x


class ESPNetC(nn.Module):
    """ESPNet-C encoder + 1×1 classifiers (stride-8 logits, stride-4 aux).

    p and q are the ESP blocks at levels 2 and 3 (the paper's 2 and 8).
    Convolution weights are drawn from `generator` on the CPU (He normal,
    fan-out, as `ResPSPNet`) and copied to `device`; biases start at 0 and
    PReLU slopes at 0.25."""

    def __init__(self, num_classes: int = 11, p: int = 2, q: int = 8, device: Device = None,
                 generator: Optional[torch.Generator] = None, dtype: DType = None):
        super().__init__()
        self.dtype = dtype
        self.p, self.q = p, q
        kw = dict(device=device, dtype=dtype)
        self.level1 = CBR(3, 16, 3, 2, **kw)
        self.br1 = BR(16 + 3, device=device)
        self.level2_down = ESP(16 + 3, 64, stride=2, add_residual=False, **kw)
        for i in range(p):
            self.add_module(f"level2_{i}", ESP(64, 64, **kw))
        self.br2 = BR(64 + 64 + 3, device=device)
        self.level3_down = ESP(64 + 64 + 3, 128, stride=2, add_residual=False, **kw)
        for i in range(q):
            self.add_module(f"level3_{i}", ESP(128, 128, **kw))
        self.br3 = BR(128 + 128, device=device)
        self.classifier = _conv(256, num_classes, 1, bias=True, **kw)
        self.aux_classifier = _conv(64 + 64 + 3, num_classes, 1, bias=True, **kw)
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, Conv2d):
                fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
                w = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(w * math.sqrt(2.0 / fan_out))
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, x: torch.Tensor, draws: Optional[Draws] = None):
        """The 7-tuple. ESPNet-C has no dropout: `draws` is accepted (the
        train step passes its uniform source to every student) and unused."""
        del draws
        if self.dtype is not None:
            x = x.to(self.dtype)
        l1 = self.level1(x)
        l1c = self.br1(torch.cat([l1, downsample_input(x, 1)], dim=1))
        l2_down = self.level2_down(l1c)
        h = l2_down
        for i in range(self.p):
            h = getattr(self, f"level2_{i}")(h)
        l2c = self.br2(torch.cat([h, l2_down, downsample_input(x, 2)], dim=1))
        l3_down = self.level3_down(l2c)
        h = l3_down
        for i in range(self.q):
            h = getattr(self, f"level3_{i}")(h)
        l3c = self.br3(torch.cat([h, l3_down], dim=1))
        logits = self.classifier(l3c)
        aux = self.aux_classifier(l2c)
        return (logits, aux, l3c, l3c, l2c, l1c, l1)
