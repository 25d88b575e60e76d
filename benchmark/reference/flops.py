"""The MFU numerator: the convolution and matmul FLOPs of one call.

A frozen copy of the counting method the program uses for itself, kept here
so that the yardstick does not change when the program does. It runs over
the benchmark's own reference step (`kd_step.py`) or forward (`nets.py`) at
a cell's shapes, on fake tensors, so the count is the same whatever
implements the step, and holds no recompute.

The call runs once under a dispatch mode that sees every aten op it
dispatches and prices the counted ones with the formulas of
`torch.utils.flop_counter`. Conventions:
  * 2 FLOPs per multiply-accumulate of every convolution (forward,
    data-gradient and weight-gradient, each at the forward's MACs) and of
    every matmul (`mm`, `bmm`, `addmm`, `baddbmm`, which `matmul` and
    `linear` become);
  * elementwise ops, reductions, pooling, softmax and the align-corners
    upsample (`F.interpolate`, no matmul here) count 0;
  * the data-gradient of a strided convolution counts at the forward's
    output positions (torch's formula);
  * the WGAN-GP's double backward counts the convolutions and matmuls it
    dispatches: the second-order terms are real work of the step.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["flops_of_fn"]

aten = torch.ops.aten
# the ops of the count: convolutions and matmuls
_COUNTED = frozenset({
    aten.convolution, aten._convolution, aten.cudnn_convolution,
    aten._slow_conv2d_forward, aten.convolution_backward,
    aten.mm, aten.bmm, aten.addmm, aten.baddbmm,
})


class _FlopCount(TorchDispatchMode):
    """Sums the FLOPs of the counted ops dispatched under it. An op torch
    can decompose (`matmul`, `conv2d`, `linear`, …) is decomposed first, so
    the count sees the ops it becomes, as `FlopCounterMode` does."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        if packet not in _COUNTED and func is not torch.ops.prim.device.default:
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        out = func(*args, **kwargs)
        if packet in _COUNTED:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        return out


def flops_of_fn(fn: Callable, *args: Any, **kwargs: Any) -> float:
    """Run `fn(*args, **kwargs)` once and return its convolution + matmul
    FLOP count (2 per MAC). The call's side effects happen: give it fake
    tensors (see the module docstring) or a state it may change."""
    counter = _FlopCount()
    with counter:
        fn(*args, **kwargs)
    return float(counter.flops)
