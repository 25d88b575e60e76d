"""Pooling ops on NCHW tensors.

Counterpart of `structure_knowledge_distillation_tpu/ops/pooling.py`:

  * ceil-mode max pooling is torch's own operator: the ResNet stem pool
    turns 512² crops into 65×65 stride-8 maps and 1024×2048 frames into
    129×257 (a window must start inside the input or its left padding,
    which is torch's rule);
  * adaptive average pooling is torch's `F.adaptive_avg_pool2d`, with
    torch's floor/ceil bin edges, which overlap when the input size does not
    divide the output size (65 → 6 bins). The JAX package computes the same
    function as two matmuls with `avg_pool_matrix` operators. The gradient
    is this module's own (`_AdaptiveAvgPool`) but for a 1 × 1 output
    (torch's mean): on CUDA torch's backward adds each bin's share into the
    input with atomics, so where bins overlap two runs of one step differ in
    the last bits, and `torch.use_deterministic_algorithms` refuses it
    whatever the sizes.

The max pool's gradient is torch's own. For the non-overlapping ceil-mode
pool of the Pa loss (k = s = 32 on 65² → 3²) the JAX package writes a tiled
first-match custom VJP (`pooling.py:103-131`): a tie routes the gradient to
the first maximum in row-major window order. `F.max_pool2d` keeps the first maximum of
a window (a strict `>` scan in row-major order) and its backward routes to
that index, which is the same rule; a test holds the two gradients equal on
tied inputs.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.ops._build import tracing

__all__ = ["max_pool_2d", "adaptive_avg_pool_2d", "AdaptiveAvgPool2d"]


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


@functools.lru_cache(maxsize=None)
def _bin_taps_np(n_in: int, n_out: int) -> tuple[np.ndarray, ...]:
    """Along one axis: for each input index the first bin that holds it, the
    second one (the first again where there is none) and 1.0 where there is
    a second one, else 0.0; and each bin's size. Torch's bins
    [floor(j·n/m), ceil((j+1)·n/m)) overlap by at most one index, so no
    index lies in more than two."""
    first = np.full(n_in, -1, dtype=np.int64)
    second = np.zeros(n_in, dtype=np.int64)
    has_second = np.zeros(n_in, dtype=np.float32)
    size = np.zeros(n_out, dtype=np.float32)
    for j in range(n_out):
        start, end = (j * n_in) // n_out, -(-((j + 1) * n_in) // n_out)
        size[j] = end - start
        for i in range(start, end):
            if first[i] < 0:
                first[i] = second[i] = j
            else:
                second[i], has_second[i] = j, 1.0
    return first, second, has_second, size


# unbounded, as the tables of ops/resize.py: a captured CUDA graph reads them
# by address, so an entry must never be evicted and freed
@functools.lru_cache(maxsize=None)
def _device_taps(n_in: int, n_out: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(a).to(device) for a in _bin_taps_np(n_in, n_out))


def _taps(n_in: int, n_out: int, device: torch.device) -> tuple[torch.Tensor, ...]:
    """`_device_taps`, made afresh where the tensors made are fake
    (`_build.tracing`; see `ops/resize.py::_operator`)."""
    if tracing():
        return _device_taps.__wrapped__(n_in, n_out, device)
    return _device_taps(n_in, n_out, device)


def _spread(g: torch.Tensor, dim: int, taps: tuple[torch.Tensor, ...]) -> torch.Tensor:
    """Each bin's gradient handed to the inputs it holds along `dim`: the
    first bin's, plus the second bin's where there is one."""
    first, second, has_second, _ = taps
    shape = [1] * g.dim()
    shape[dim] = first.numel()
    return (g.index_select(dim, first)
            + g.index_select(dim, second) * has_second.to(g.dtype).view(shape))


class _AdaptiveAvgPool(torch.autograd.Function):
    """`F.adaptive_avg_pool2d` with a backward in a fixed order. Each bin's
    gradient is divided by its height, then its width, as torch's kernels
    divide it; each input then gathers the bins that hold it, along W and
    then along H. Torch's CPU kernel adds the same terms, so the two agree
    to the last bit except at an index held by 2 × 2 bins, which sums its
    four terms in another order."""

    @staticmethod
    def forward(ctx, x, output_size):
        ctx.hw = tuple(x.shape[2:])
        return F.adaptive_avg_pool2d(x, output_size)

    @staticmethod
    def backward(ctx, grad):
        (h, w), (oh, ow) = ctx.hw, grad.shape[2:]
        taps_h, taps_w = _taps(h, oh, grad.device), _taps(w, ow, grad.device)
        g = grad / taps_h[3].to(grad.dtype).view(oh, 1) / taps_w[3].to(grad.dtype).view(1, ow)
        return _spread(_spread(g, 3, taps_w), 2, taps_h), None


def adaptive_avg_pool_2d(x: torch.Tensor, output_size: tuple[int, int]) -> torch.Tensor:
    """torch AdaptiveAvgPool2d on an NCHW tensor. Where a gradient is wanted
    and the output is not 1 × 1, through `_AdaptiveAvgPool`, whose backward
    sums in a fixed order on every device; a 1 × 1 output is torch's mean,
    whose backward has no atomics."""
    if tuple(output_size) != (1, 1) and torch.is_grad_enabled() and x.requires_grad:
        return _AdaptiveAvgPool.apply(x, tuple(output_size))
    return F.adaptive_avg_pool2d(x, output_size)


class AdaptiveAvgPool2d(nn.Module):
    """`adaptive_avg_pool_2d` as a module, in `nn.AdaptiveAvgPool2d`'s place
    (no parameters or buffers, so no state-dict keys)."""

    def __init__(self, output_size: tuple[int, int]):
        super().__init__()
        self.output_size = tuple(output_size)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return adaptive_avg_pool_2d(x, self.output_size)

    def extra_repr(self) -> str:
        return f"output_size={self.output_size}"
