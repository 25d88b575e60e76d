"""Train state and optimizers for the KD pipeline.

Counterpart of `structure_knowledge_distillation_tpu/training/train_state.py`
(reference networks/kd_model.py:53-117). Where the JAX state is one pytree
that the jitted step returns anew, here `KDTrainState` holds the live
modules and the two optimizers, and the step updates them in place.

The optimizers are `torch.optim.SGD` objects with momentum and weight decay,
which hold the momentum buffers and give the checkpoints their
`state_dict` format; the update itself is `sgd_update`: decay is added to
the gradient before the momentum buffer and the update is −lr·buf, the rule
of the JAX optax chain (`add_decayed_weights` + `sgd`, `train_state.py:
40-48`), as foreach operations that read the lr from a tensor on the
parameters' device. So a captured CUDA graph replays it with the lr the
host wrote before the replay (`SGD.step` would bake a Python lr into the
graph, and its foreach path reads a tensor lr with `.item()`, a host sync
that capture refuses), and the eager step runs the same code. The lr follows
the poly schedule
lr·(remaining/num_steps)^power with an integer remainder, set on both
optimizers before each update, from `KDTrainState.step`. So a run that
starts at an offset (`last_step`, or a resumed checkpoint) sets `step` and
the next update takes the lr the unbroken run would: the JAX package moves
its optax schedule counts for that (`_set_schedule_count`), which the port
needs no counterpart of. `flat_sgd` is not ported (ROADMAP "Not ported": a
TPU measure).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

__all__ = ["KDTrainState", "poly_schedule", "make_sgd", "set_lr", "sgd_update",
           "momentum_buffers"]


def poly_schedule(base_lr: float, num_steps: int, power: float) -> Callable[[int], float]:
    """count -> base_lr·((num_steps − min(count, num_steps)) / num_steps)^power,
    in float32 as the JAX schedule: the integer subtraction comes first, so
    the end of the schedule has no cancellation."""
    def schedule(count: int) -> float:
        remaining = num_steps - min(int(count), num_steps)
        frac = np.float32(remaining) / np.float32(num_steps)
        return float(np.float32(base_lr) * frac ** np.float32(power))

    return schedule


def make_sgd(params: Iterable[torch.nn.Parameter], base_lr: float, momentum: float,
             weight_decay: float) -> torch.optim.SGD:
    """A torch SGD holding the hyperparameters and the momentum buffers;
    `sgd_update` applies its rule, and `set_lr` records the last lr in its
    param groups."""
    return torch.optim.SGD(list(params), lr=base_lr, momentum=momentum,
                           weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


def momentum_buffers(opt: torch.optim.SGD, params: Sequence[torch.Tensor]) -> list:
    """The momentum buffer of each parameter in `opt.state` (where
    `SGD.state_dict` finds it), made as zeros where there is none yet: a
    first update then sets it to the gradient, as `SGD.step` does."""
    bufs = []
    for p in params:
        state = opt.state[p]
        if state.get("momentum_buffer") is None:
            state["momentum_buffer"] = torch.zeros_like(p, memory_format=torch.preserve_format)
        bufs.append(state["momentum_buffer"])
    return bufs


@torch.no_grad()
def sgd_update(opt: torch.optim.SGD, params: Sequence[torch.Tensor],
               grads: Sequence[torch.Tensor], lr: torch.Tensor) -> None:
    """One SGD update of `params` in place: d = g + wd·p, buf = m·buf + d,
    p −= lr·buf, with `opt`'s momentum and weight decay (one param group)
    and `lr` a 0-dim f32 tensor on the parameters' device."""
    (group,) = opt.param_groups
    wd, momentum = group["weight_decay"], group["momentum"]
    d = torch._foreach_add(grads, params, alpha=wd) if wd else list(grads)
    if momentum:
        bufs = momentum_buffers(opt, params)
        torch._foreach_mul_(bufs, momentum)
        torch._foreach_add_(bufs, d)
        d = bufs
    torch._foreach_sub_(list(params), torch._foreach_mul(d, lr))


@dataclass
class KDTrainState:
    """The frozen teacher, the student (G) and the discriminator (D) with
    their optimizers and schedules; `step` counts the updates made (from
    `last_step` at construction), and the next update's lr is
    `g_sched(step)` / `d_sched(step)`."""

    teacher: torch.nn.Module
    student: torch.nn.Module
    discriminator: torch.nn.Module
    g_opt: torch.optim.SGD
    d_opt: torch.optim.SGD
    g_sched: Callable[[int], float]
    d_sched: Callable[[int], float]
    step: int = 0
