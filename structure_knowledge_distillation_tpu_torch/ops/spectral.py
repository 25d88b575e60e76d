"""Spectral normalization for conv weights, with power-iteration state.

Counterpart of `structure_knowledge_distillation_tpu/ops/spectral.py`
(reference networks/spectral.py:23-63): one power iteration per forward from
the persisted u, the effective weight is W/σ with σ = u·(W v) taken with the
NEW u and v, and the gradient flows through W only.

The module tree follows the reference's `SpectralNorm` wrapper, so the
state-dict keys are the reference's: the wrapped conv is the submodule
`module`, holding the parameters `weight_bar` (the un-normalised OIHW weight)
and `bias`, and the buffers `weight_u` (O,) and `weight_v` (I·kh·kw,). The
power iteration flattens the weight in torch's OIHW order.

A train-mode forward rebinds u and v (autograd saved the previous ones);
`spectral_in_place` puts the final values back into the buffers a train
step started from, so `state_dict` and a CUDA graph, which reads the buffers
it saw at capture, find them there.
"""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

__all__ = ["SNConv", "spectral_in_place"]


def _l2normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    return v / (torch.linalg.vector_norm(v) + eps)


class SNConv(nn.Module):
    """2-D convolution whose weight is spectrally normalized.

    In train mode each forward advances u and v by one power iteration and
    stores them; in eval mode the iteration runs but is not stored (the JAX
    `update_stats=False`). The iteration and σ are f32; the normalised weight
    is cast to `dtype` (None: the input's) after the division, and the
    convolution runs in that dtype. u and v are rebound, not written in
    place, so a graph that saved the previous ones stays valid.
    """

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int = 4,
                 stride: int = 2, padding: int = 1, dtype: Optional[torch.dtype] = None,
                 device: torch.device | str | None = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.stride = stride
        self.padding = padding
        self.dtype = dtype
        self.module = nn.Module()
        fan_in = in_channels * kernel_size * kernel_size
        w = torch.randn((out_channels, in_channels, kernel_size, kernel_size),
                        generator=generator) / math.sqrt(fan_in)
        self.module.weight_bar = nn.Parameter(w.to(device))
        self.module.bias = nn.Parameter(torch.zeros(out_channels, device=device))
        u = _l2normalize(torch.randn(out_channels, generator=generator))
        v = _l2normalize(torch.randn(fan_in, generator=generator))
        self.module.register_buffer("weight_u", u.to(device))
        self.module.register_buffer("weight_v", v.to(device))

    def normalized_weight(self) -> torch.Tensor:
        """W/σ in f32 after one power iteration (stored in train mode)."""
        w = self.module.weight_bar
        w_mat = w.reshape(w.shape[0], -1)
        with torch.no_grad():
            v = _l2normalize(w_mat.t() @ self.module.weight_u)
            u = _l2normalize(w_mat @ v)
        if self.training:
            self.module.weight_u = u
            self.module.weight_v = v
        sigma = u @ (w_mat @ v)
        return w / sigma

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype if self.dtype is not None else x.dtype
        w = self.normalized_weight().to(dt)
        y = F.conv2d(x.to(dt), w, stride=self.stride, padding=self.padding)
        return y + self.module.bias.to(y.dtype).view(1, -1, 1, 1)


@contextlib.contextmanager
def spectral_in_place(module: nn.Module) -> Iterator[None]:
    """Within the block every SNConv of `module` may rebind u and v; when it
    ends, the final u and v are copied into the buffers bound when it began,
    and those are bound again. The buffers are bound again if the block
    raises, without the copy."""
    homes = [(m.module, m.module.weight_u, m.module.weight_v)
             for m in module.modules() if isinstance(m, SNConv)]
    try:
        yield
        with torch.no_grad():
            for holder, u, v in homes:
                if holder.weight_u is not u:
                    u.copy_(holder.weight_u)
                    v.copy_(holder.weight_v)
    finally:
        for holder, u, v in homes:
            holder.weight_u, holder.weight_v = u, v
