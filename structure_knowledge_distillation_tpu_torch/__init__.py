"""structure_knowledge_distillation_tpu_torch — the PyTorch/CUDA port.

A second package beside the JAX one (`structure_knowledge_distillation_tpu`),
with the same sub-package and module names so that each module's counterpart
is easy to find. The JAX package is the reference: the port's tests feed both
the same inputs and compare.

Rules of the package:
  * it imports torch, numpy and the standard library, never jax, flax or the
    JAX package (the GPU machine has no JAX);
  * modules are NCHW `nn.Module`s with an explicit `device` argument;
  * state-dict names are the reference's torch keys, so the released `.pth`
    checkpoints and `export_torch_respspnet` dicts load directly;
  * every TPU kernel on a ported path is a hand-written Hopper kernel under
    `csrc/`, built by `ops/_build.py` on first use, with a plain PyTorch
    version beside it that CPU tensors take.

Ported so far: the whole-image evaluation path of the PSPNet students and
teachers (`cli/eval.py` → `training/evaluate.py::evaluate_main`) and the
Pi+Pa+Ho distillation train step (`cli/train.py` →
`training/trainer.py::KDTrainer.fit` → `training/train_step.py`), with its
multi-step loop (`unroll_steps > 1`: one CUDA-graph replay per chunk on the
card).
"""

__version__ = "0.1.0"
