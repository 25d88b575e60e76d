"""Train state and optimizers for the KD pipeline.

Counterpart of `structure_knowledge_distillation_tpu/training/train_state.py`
(reference networks/kd_model.py:53-117). Where the JAX state is one pytree
that the jitted step returns anew, here `KDTrainState` holds the live
modules and the two optimizers, and the step updates them in place.

The optimizers are `torch.optim.SGD` with momentum and weight decay: decay is
added to the gradient before the momentum buffer and the update is −lr·buf,
the rule of the JAX optax chain (`add_decayed_weights` + `sgd`,
`train_state.py:40-48`). The lr follows the poly schedule
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
from typing import Callable, Iterable

import numpy as np
import torch

__all__ = ["KDTrainState", "poly_schedule", "make_sgd", "set_lr"]


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
    """torch SGD with the JAX chain's rule; the caller sets the lr from
    `poly_schedule` before each `step()` (`set_lr`)."""
    return torch.optim.SGD(list(params), lr=base_lr, momentum=momentum,
                           weight_decay=weight_decay)


def set_lr(opt: torch.optim.Optimizer, lr: float) -> None:
    for group in opt.param_groups:
        group["lr"] = lr


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
