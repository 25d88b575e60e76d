"""Task (segmentation) losses: DSN cross-entropy with ignore-index.

Counterpart of `structure_knowledge_distillation_tpu/losses/task.py`
(reference utils/criterion.py:168-188, CriterionDSN): the main and auxiliary
(DSN) logits are upsampled (align-corners) to the label resolution, the
cross-entropy ignores label 255 and averages over the other pixels, and the
total is main + 0.4·aux. Logits are NCHW. With a process group (data
parallel) each loss is this rank's share of the global batch's: the rank's
sum over the all-reduced valid count (`ops/upsampled_ce.py`).
"""

from __future__ import annotations

import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import (
    cross_entropy_ignore,
    upsampled_ce_loss,
    upsampled_ce_loss_dsn,
)

__all__ = ["cross_entropy_ignore", "criterion_dsn", "criterion_dsn_fused"]


def criterion_dsn(preds: tuple, labels: torch.Tensor, ignore_index: int = 255,
                  dsn_weight: float = 0.4, group=None) -> torch.Tensor:
    """CE(main ↑ label size) + dsn_weight·CE(aux ↑ label size), materialised.

    The upsample runs in f32 for f32 logits and in the logits' own dtype
    otherwise, as the JAX version does."""
    h, w = labels.shape[1], labels.shape[2]
    exact = preds[0].dtype == torch.float32
    main = resize_bilinear_align_corners(preds[0], (h, w), exact=exact)
    aux = resize_bilinear_align_corners(preds[1], (h, w), exact=exact)
    return (cross_entropy_ignore(main, labels, ignore_index, group)
            + dsn_weight * cross_entropy_ignore(aux, labels, ignore_index, group))


def criterion_dsn_fused(preds: tuple, labels: torch.Tensor, ignore_index: int = 255,
                        dsn_weight: float = 0.4, group=None) -> torch.Tensor:
    """The DSN loss through the upsampled-CE kernels: one two-head pass (K4/K5)
    when the heads agree in shape and dtype, else the one-head kernel (K2/K3)
    twice. There is no memory-budget gate: the JAX one measured TPU VMEM."""
    h, w = labels.shape[1], labels.shape[2]
    main, aux = preds[0], preds[1]
    if main.shape == aux.shape and main.dtype == aux.dtype:
        return upsampled_ce_loss_dsn(main, aux, labels, (h, w), ignore_index, dsn_weight,
                                     group)
    return (upsampled_ce_loss(main, labels, (h, w), ignore_index, group)
            + dsn_weight * upsampled_ce_loss(aux, labels, (h, w), ignore_index, group))
