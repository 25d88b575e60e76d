"""Work counts of a cell, taken on fake tensors: FLOPs of the reference step
or forward at the cell's shapes (the MFU numerators) and the shapes the
kernels' rooflines are priced at."""

from __future__ import annotations

import torch
from torch._subclasses import FakeTensorMode

from benchmark.reference import archs, kd_step, nets, weights
from benchmark.reference.flops import flops_of_fn
from benchmark.reference.precision import Exact

__all__ = ["train_step_counts", "eval_frame_counts"]


def _fake_batch(n, crop, classes):
    return torch.randn(n, 3, *crop), torch.randint(0, classes, (n, *crop))


def train_step_counts(specs: dict, recipe: kd_step.Recipe, n: int, crop) -> dict:
    """FLOPs of one reference step on a batch of n crops, and the shapes of
    the student's heads (the main one, then the auxiliary one where the
    student has it)."""
    with FakeTensorMode():
        state = {k: weights.make_state(specs[k], None, "cpu")
                 for k in ("teacher", "student", "disc")}
        state.update(g_buf={}, d_buf={})
        batch = _fake_batch(n, crop, recipe.classes)
        draws = lambda shape: torch.rand(shape)  # noqa: E731
        flops = flops_of_fn(kd_step.ref_steps, specs, state, [batch], recipe, Exact(), draws,
                            0, host=False)
        c = nets.Ctx(dict(state["student"]), Exact(), False)
        main, aux, _ = archs.forward(c, specs["student"], batch[0])
        heads = [tuple(h.shape) for h in (main, aux) if h is not None]
    return {"flops_per_step": flops, "heads": heads}


def eval_frame_counts(spec: dict, frame) -> dict:
    """FLOPs of the reference's forward of one frame, and its logits' shape."""
    with FakeTensorMode():
        state = weights.make_state(spec, None, "cpu")
        x = torch.randn(1, 3, *frame)
        holder = {}

        def fwd():
            holder["logits"] = archs.forward(nets.Ctx(dict(state), Exact(), False), spec, x)[0]

        flops = flops_of_fn(fwd)
        shape = tuple(holder["logits"].shape)
    return {"flops_per_frame": flops, "logits": shape}
