"""The MFU numerator: the convolution and matmul FLOPs of one call.

Counterpart of `structure_knowledge_distillation_tpu/utils/flops.py`
(`flops_of_fn`). The JAX version walks the function's jaxpr; here the call
runs once under a dispatch mode that sees every aten op it dispatches and
prices each with the formulas of `torch.utils.flop_counter`, as that
module's `FlopCounterMode` does. That mode itself also tracks modules with
gradient hooks, which `torch.autograd.grad` over a leaf refuses (the WGAN-GP
takes the gradient w.r.t. its interpolate), so it is not used. The
convention is the JAX one, the usual "model
FLOPs": 2 FLOPs per multiply-accumulate of every convolution (forward,
data-gradient and weight-gradient, each counted at the forward's MACs) and
every matmul (`mm`, `bmm`, `addmm`, `baddbmm`, which `matmul` and `linear`
become); elementwise ops, reductions and pooling count 0.

Run it on fake tensors to count without computing: build the modules and the
inputs inside `torch._subclasses.FakeTensorMode()` and call `flops_of_fn`
there too. The port's train step runs under it (its draws, optimizers and
autograd Functions included); on real tensors the count is the same, as the
ops and shapes are.

What the count leaves out, and where it differs from the JAX package's:
  * hand-written kernels count 0: K1–K9 do no matmul (K4/K5 and K1
    interpolate by taps), so a step with `fused_ce` or `bn_fused` on counts
    less than the same step with them off by the dense upsample matmuls of
    the plain CE and nothing else;
  * the JAX count of a step with Pallas kernels on counts the body of each
    `pallas_call` once, not once per grid step (a 64×64 @ 64×64 matmul over
    a 4-block grid counts 131,072 FLOPs of its 524,288); the port does not
    copy that;
  * the PSP's adaptive average pool is `F.adaptive_avg_pool2d` here (0) and
    two `avg_pool_matrix` dots in JAX (`ops/pooling.py:135-146`), forward and
    backward: per pool of (N, C, H, W) to s × s bins,
    2·N·C·(s·H·W + s·s·W) each way;
  * the data-gradient of a strided convolution: torch counts it at the
    forward's output positions, JAX at the input's positions divided by the
    stride's product, which differ where an input side is not stride × the
    output side (129 → 65 at stride 2);
  * the align-corners resize is a matmul in both packages
    (`ops/resize.py:81-83`) and counts the same.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

__all__ = ["flops_of_fn"]

aten = torch.ops.aten
# the ops of the count: convolutions and matmuls, as the JAX count takes
# conv_general_dilated and dot_general
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
