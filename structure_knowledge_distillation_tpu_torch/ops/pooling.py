"""Pooling ops on NCHW tensors.

Counterpart of `structure_knowledge_distillation_tpu/ops/pooling.py`, which
rebuilds torch's pooling semantics on XLA. Here torch's own operators are
those semantics:

  * ceil-mode max pooling: the ResNet stem pool turns 512² crops into 65×65
    stride-8 maps and 1024×2048 frames into 129×257 (a window must start
    inside the input or its left padding, which is torch's rule);
  * adaptive average pooling with torch's floor/ceil bin edges, which overlap
    when the input size does not divide the output size (65 → 6 bins).

Gradients are torch's own. For the non-overlapping ceil-mode pool of the Pa
loss (k = s = 32 on 65² → 3²) the JAX package writes a tiled first-match
custom VJP (`pooling.py:103-131`): a tie routes the gradient to the first
maximum in row-major window order. `F.max_pool2d` keeps the first maximum of
a window (a strict `>` scan in row-major order) and its backward routes to
that index, which is the same rule; a test holds the two gradients equal on
tied inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["max_pool_2d", "adaptive_avg_pool_2d"]


def max_pool_2d(
    x: torch.Tensor,
    kernel: tuple[int, int],
    stride: tuple[int, int] | None = None,
    padding: tuple[int, int] = (0, 0),
    ceil_mode: bool = False,
) -> torch.Tensor:
    """Max pooling over the H, W axes of an NCHW tensor, torch semantics."""
    return F.max_pool2d(x, kernel, stride if stride is not None else kernel,
                        padding, ceil_mode=ceil_mode)


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on an NCHW tensor."""
    return F.adaptive_avg_pool2d(x, output_size)
