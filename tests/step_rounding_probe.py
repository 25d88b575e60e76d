"""Is the gap between the JAX and the port's f32 train step rounding?

Run on the CPU from the repository root (imports both packages, as the
tests do):

    JAX_PLATFORMS=cpu python tests/step_rounding_probe.py

One step of each ablation arm on two of the harness's frames (seed 0's
first chunk at batch 2; `test_torch_port_ablate_kd.arm_step`): the JAX f32
step, the port's f32 step and the port's f64 step with its new parameters
stored in f32. Prints, per arm and model, the worst update gap (the
2 %-envelope quantity) of JAX f32 and of the port's f32 against the f64
step, and between the two f32 steps. Then the pi+pa+ho arm on the same
frames times (1 + 2^-22 · n), n ~ N(0, 1), in five draws: each f32 step's
gap to that draw's f64 update on a few tensors, and how far the f64 update
itself moved.
"""

from __future__ import annotations

import os
import sys

import jax
import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]
jax.config.update("jax_platforms", "cpu")  # as tests/conftest.py sets them
jax.config.update("jax_default_matmul_precision", "highest")

from test_torch_port_ablate_kd import (  # noqa: E402
    _toy_batch,
    _worst_update_gap,
    ab,
    arm_step,
    make_jax_start,
)

TENSORS = (("discriminator", "preprocess_additional.weight"),
           ("discriminator", "l1.0.module.weight_bar"),
           ("student", "layer1.0.bn1.bias"), ("student", "layer2.0.bn2.bias"))


def _gap(a, b, before):
    return float(np.linalg.norm((a - before) - (b - before)) / np.linalg.norm(b - before))


def main() -> None:
    torch.set_num_threads(4)
    start = make_jax_start()
    images, labels = _toy_batch(2)
    for arm in ab.ARM_NAMES:
        _, _, jax_sds, before, p32 = arm_step(start, arm, images, labels)
        _, _, _, _, p64 = arm_step(start, arm, images, labels, f64=True)
        for i, model in enumerate(("student", "discriminator")):
            print(f"{arm} {model}: JAX32 vs port64 %.4f at %s | port32 vs port64 %.4f at %s | "
                  "JAX32 vs port32 %.4f at %s" % (
                      *_worst_update_gap(jax_sds[i], before[i], p64[i]),
                      *_worst_update_gap(p32[i], before[i], p64[i]),
                      *_worst_update_gap(jax_sds[i], before[i], p32[i])), flush=True)
    rng = np.random.RandomState(1)
    first = None
    for draw in range(5):
        noisy = images if draw == 0 else (images.double() * (
            1 + 2.0 ** -22 * torch.from_numpy(rng.randn(*images.shape)))).float()
        _, _, jax_sds, before, p32 = arm_step(start, "pi+pa+ho", noisy, labels)
        _, _, _, _, p64 = arm_step(start, "pi+pa+ho", noisy, labels, f64=True)
        parts = []
        for model, key in TENSORS:
            i = 0 if model == "student" else 1
            parts.append(f"{key}: JAX32 %.4f port32 %.4f" % (
                _gap(jax_sds[i][key], p64[i][key], before[i][key]),
                _gap(p32[i][key], p64[i][key], before[i][key])))
        key = "preprocess_additional.weight"
        moved = 0.0 if first is None else _gap(p64[1][key], first, before[1][key])
        first = p64[1][key] if first is None else first
        print(f"draw {draw}: " + " | ".join(parts) + f" | f64 update moved {moved:.1e}",
              flush=True)


if __name__ == "__main__":
    main()
