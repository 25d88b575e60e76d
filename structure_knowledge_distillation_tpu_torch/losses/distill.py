"""Structured distillation losses: pixel-wise KL (Pi) and pairwise affinity (Pa).

Counterpart of `structure_knowledge_distillation_tpu/losses/distill.py`, NCHW:
  * Pi (reference utils/criterion.py:211-226): cross-entropy of the
    student's log-softmax against the teacher's softmax over the stride-8
    logits, summed over batch, pixels and classes and divided by H·W only,
    not by the batch (lambda_pi = 10 is calibrated to that);
  * Pa (reference utils/criterion.py:228-245, utils/utils.py:170-183):
    ceil-mode max pool of the post-PSP features by `scale`, channel L2
    normalisation by a detached norm + 1e-8, the B×N×N Gram matrix, and
    sum((G_T − G_S)²) / N² / B.
Both compute in f32 whatever the logits' dtype; the teacher side is detached.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.ops.pooling import max_pool_2d

__all__ = ["pixel_wise_kl", "similarity_gram", "sim_dis_compute", "pairwise_affinity_loss"]


def pixel_wise_kl(logits_s: torch.Tensor, logits_t: torch.Tensor) -> torch.Tensor:
    """sum(−softmax(T)·log_softmax(S)) / (H·W) over (N, C, H, W) logits."""
    if logits_s.shape != logits_t.shape:
        raise ValueError(f"student/teacher logits differ: {tuple(logits_s.shape)} "
                         f"vs {tuple(logits_t.shape)}")
    h, w = logits_s.shape[2], logits_s.shape[3]
    p_t = F.softmax(logits_t.detach().float(), dim=1)
    logp_s = F.log_softmax(logits_s.float(), dim=1)
    return (-p_t * logp_s).sum() / (h * w)


def similarity_gram(feat: torch.Tensor) -> torch.Tensor:
    """B×N×N affinity of channel-normalised (N, C, H, W) features, in f32."""
    f = feat.float()
    norm = torch.sqrt((f * f).sum(dim=1, keepdim=True)) + 1e-8
    f = f / norm.detach()
    n, c, h, w = f.shape
    f = f.reshape(n, c, h * w)
    return torch.bmm(f.transpose(1, 2), f)


def sim_dis_compute(feat_s: torch.Tensor, feat_t: torch.Tensor) -> torch.Tensor:
    """sum((G_T − G_S)²) / (H·W)² / B."""
    n, _, h, w = feat_t.shape
    diff = similarity_gram(feat_t.detach()) - similarity_gram(feat_s)
    return (diff * diff).sum() / ((h * w) ** 2) / n


def pairwise_affinity_loss(feat_s: torch.Tensor, feat_t: torch.Tensor,
                           scale: float = 0.5) -> torch.Tensor:
    """Pa: ceil-mode max pool of both features with kernel = stride =
    int(dim·scale) per spatial axis (65² with scale 0.5 → 3²), then the
    affinity distance."""
    h, w = feat_t.shape[2], feat_t.shape[3]
    kh, kw = int(h * scale), int(w * scale)
    pool = lambda f: max_pool_2d(f, (kh, kw), (kh, kw), (0, 0), ceil_mode=True)  # noqa: E731
    return sim_dis_compute(pool(feat_s), pool(feat_t))
