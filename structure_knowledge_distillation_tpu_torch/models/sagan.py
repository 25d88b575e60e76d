"""SAGAN-style discriminator for the holistic (Ho) distillation loss.

Counterpart of `structure_knowledge_distillation_tpu/models/sagan.py`
(reference networks/sagan_models.py:105-168), NCHW, with the reference's
module tree so that its state-dict keys are those of the JAX package's
`export_torch_discriminator`:
  * `preprocess_additional`: BatchNorm2d over the score map (mode 1; mode 2
    is tanh, mode 3 rescales a [0, 255] input to [-1, 1]);
  * `l1`–`l3` (and `l4` only when `image_size == 65`): spectral-norm 4×4/s2
    convs C→64→128→256(→512), each `nn.Sequential(SNConv, LeakyReLU(0.1))`,
    so the keys read `l1.0.module.weight_bar`;
  * `attn1` after l3 and `attn2` after l4 (or after attn1 when l4 is gated
    off, at conv_dim·4 channels), each with `{query,key,value}_conv` and
    `gamma`;
  * `last.0`: the 4×4 valid conv to one score per image.

`dtype` is the compute dtype (None: the input's), as in the JAX model: the
convs run in it, while the BN statistics, the power iteration and the
attention softmax stay f32, and the score comes back in f32.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.models.resnet_pspnet import Conv2d
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import BatchNorm2d
from structure_knowledge_distillation_tpu_torch.ops.spectral import SNConv

__all__ = ["SelfAttention", "Discriminator"]

DType = Optional[torch.dtype]


def _lecun_init(conv: nn.Conv2d, generator: Optional[torch.Generator]) -> None:
    fan_in = conv.in_channels * conv.kernel_size[0] * conv.kernel_size[1]
    with torch.no_grad():
        w = torch.randn(conv.weight.shape, generator=generator) / math.sqrt(fan_in)
        conv.weight.copy_(w)
        conv.bias.zero_()


class SelfAttention(nn.Module):
    """out = gamma·(V applied with softmax(QᵀK)) + x over spatial positions
    (reference sagan_models.py:9-41); gamma starts at 0."""

    def __init__(self, channels: int, dtype: DType = None, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.query_conv = Conv2d(channels, channels // 8, 1, device=device, compute_dtype=dtype)
        self.key_conv = Conv2d(channels, channels // 8, 1, device=device, compute_dtype=dtype)
        self.value_conv = Conv2d(channels, channels, 1, device=device, compute_dtype=dtype)
        self.gamma = nn.Parameter(torch.zeros(1, device=device))
        for conv in (self.query_conv, self.key_conv, self.value_conv):
            _lecun_init(conv, generator)

    def forward(self, x: torch.Tensor):
        n, c, h, w = x.shape
        q = self.query_conv(x).reshape(n, -1, h * w).transpose(1, 2)  # (n, hw, c/8)
        k = self.key_conv(x).reshape(n, -1, h * w)                    # (n, c/8, hw)
        v = self.value_conv(x).reshape(n, c, h * w)                   # (n, c, hw)
        energy = torch.bmm(q, k)                                      # [b, i, j] = q_i·k_j
        attention = F.softmax(energy.float(), dim=-1).to(energy.dtype)
        out = torch.bmm(v, attention.transpose(1, 2)).reshape(n, c, h, w)
        return self.gamma.to(x.dtype) * out + x, attention


class Discriminator(nn.Module):
    """Spectral-norm conditional discriminator over segmentation score maps.

    forward(x) takes (N, num_classes, s, s) scores and returns
    (score (N, 1, 1, 1) f32, attention1, attention2). Weights are drawn from
    `generator` on the CPU and copied to `device`."""

    def __init__(self, num_classes: int = 19, preprocess_mode: int = 1,
                 image_size: int = 65, conv_dim: int = 64, dtype: DType = None,
                 device=None, generator: Optional[torch.Generator] = None):
        super().__init__()
        if preprocess_mode not in (1, 2, 3):
            raise ValueError("preprocess_mode should be 1 (bn), 2 (tanh) or 3 (scale)")
        self.preprocess_mode = preprocess_mode
        self.image_size = image_size
        if preprocess_mode == 1:
            self.preprocess_additional = BatchNorm2d(num_classes, device=device)

        def sn_block(cin: int, cout: int) -> nn.Sequential:
            return nn.Sequential(SNConv(cin, cout, 4, 2, 1, dtype=dtype, device=device,
                                        generator=generator),
                                 nn.LeakyReLU(0.1))

        self.l1 = sn_block(num_classes, conv_dim)
        self.l2 = sn_block(conv_dim, conv_dim * 2)
        self.l3 = sn_block(conv_dim * 2, conv_dim * 4)
        self.attn1 = SelfAttention(conv_dim * 4, dtype, device, generator)
        width = conv_dim * 4
        if image_size == 65:
            self.l4 = sn_block(conv_dim * 4, conv_dim * 8)
            width = conv_dim * 8
        self.attn2 = SelfAttention(width, dtype, device, generator)
        self.last = nn.Sequential(Conv2d(width, 1, 4, device=device, compute_dtype=dtype))
        _lecun_init(self.last[0], generator)

    def forward(self, x: torch.Tensor):
        if self.preprocess_mode == 1:
            x = self.preprocess_additional(x)
        elif self.preprocess_mode == 2:
            x = torch.tanh(x)
        else:
            x = 2.0 * (x / 255.0 - 0.5)
        out = self.l3(self.l2(self.l1(x)))
        out, p1 = self.attn1(out)
        if self.image_size == 65:
            out = self.l4(out)
        out, p2 = self.attn2(out)
        return self.last(out).float(), p1, p2
