"""OHEM cross-entropy: hard-example mining with static shapes.

Counterpart of `structure_knowledge_distillation_tpu/losses/ohem.py`
(reference utils/criterion.py:11-90, OhemCrossEntropy2d, and :190-209,
CriterionOhemDSN). Logits are NCHW. The threshold search runs on the device
with no host round trip, so a train step with OHEM can be captured as a
CUDA graph:
  * the softmax is downsampled by `factor` with align-corners bilinear and
    the labels with align-corners nearest (scipy `zoom(order=1)` /
    `zoom(order=0)` on the reference's grid: output index i reads input
    coordinate i·(in−1)/(out−1), out = round(in/factor), order 0 rounding
    by floor(x + 0.5));
  * the threshold is the k-th smallest ground-truth probability among the
    valid downsampled pixels of the WHOLE batch (k = min_kept // factor²,
    static), never below `thresh`; 1.0 when k ≥ the valid count (a device
    `torch.where`, no `.item()`); `thresh` itself when min_kept is 0;
  * the CE is a mean over the kept full-resolution pixels (valid, with a
    ground-truth probability ≤ the threshold).
The selection takes no gradient, as in the JAX function: only the CE does.

With a process group (data parallel), the batch is the global one: the
threshold comes from every rank's down-sampled ground-truth probabilities
(`gather_rows`) and the all-reduced valid count, so it is the same on every
rank and equal to the one-process threshold, and the CE is this rank's
share: its kept sum over the global kept count. k stays static and nothing
reads a value on the host, so the step still captures.
"""

from __future__ import annotations

import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import cross_entropy_ignore
from structure_knowledge_distillation_tpu_torch.parallel.data_parallel import (
    all_reduce_sum,
    gather_rows,
)

__all__ = ["criterion_ohem_dsn", "ohem_cross_entropy", "ohem_threshold"]


def _zoom0_indices(n: int, out: int, device) -> torch.Tensor:
    """scipy `zoom(order=0)` source indices round(i·(n−1)/(out−1)), in the
    JAX function's f32 arithmetic: an f32 arange times the ratio, then
    floor(x + 0.5)."""
    if out <= 1:
        return torch.zeros(max(out, 1), dtype=torch.long, device=device)
    coords = torch.arange(out, dtype=torch.float32, device=device) * ((n - 1) / (out - 1))
    return torch.floor(coords + 0.5).long()


def _gt_prob(probs: torch.Tensor, labels: torch.Tensor, ignore_index: int):
    """(valid mask, probability of each pixel's label; label 0 where ignored)."""
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    return valid, probs.gather(1, safe[:, None])[:, 0]


def _threshold(probs: torch.Tensor, labels: torch.Tensor, ignore_index: int, thresh: float,
               min_kept: int, factor: int, group=None) -> torch.Tensor:
    _, _, h, w = probs.shape
    out_h, out_w = int(round(h / factor)), int(round(w / factor))
    ds_probs = resize_bilinear_align_corners(probs, (out_h, out_w))
    row = _zoom0_indices(h, out_h, labels.device)
    col = _zoom0_indices(w, out_w, labels.device)
    ds_valid, ds_prob = _gt_prob(ds_probs, labels[:, row][:, :, col], ignore_index)
    k = max(min_kept // (factor * factor), 0)
    n_valid = ds_valid.sum()
    # invalid pixels at +inf: they sort after every valid one
    masked = torch.where(ds_valid, ds_prob, torch.full_like(ds_prob, float("inf")))
    if group is not None:
        (n_valid,) = all_reduce_sum([n_valid], group)
        masked = gather_rows(masked, group)
    if k > 0:
        flat = masked.reshape(-1)
        kk = min(k, flat.numel())
        # the kk-th smallest: the last of the kk smallest, sorted ascending
        kth = torch.topk(flat, kk, largest=False, sorted=True).values[kk - 1]
        threshold = torch.clamp(kth, min=thresh)
    else:
        # the reference: min_kept == 0 leaves the threshold at `thresh`
        threshold = torch.full((), thresh, dtype=torch.float32, device=probs.device)
    return torch.where(n_valid <= k, torch.ones_like(threshold), threshold)


@torch.no_grad()
def ohem_threshold(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                   thresh: float = 0.7, min_kept: int = 100000, factor: int = 8,
                   group=None) -> torch.Tensor:
    """The 0-dim f32 probability threshold of `ohem_cross_entropy` for
    (N, C, H, W) logits and (N, H, W) labels, on their device (with a
    process group, over the global batch)."""
    return _threshold(torch.softmax(logits.float(), dim=1), labels.long(), ignore_index,
                      thresh, min_kept, factor, group)


def ohem_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, ignore_index: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000, factor: int = 8,
                       group=None) -> torch.Tensor:
    """Hard-example-mined CE of (N, C, H, W) logits against (N, H, W)
    integer labels, in f32 (with a process group, this rank's share of the
    global batch's)."""
    labels = labels.long()
    with torch.no_grad():
        probs = torch.softmax(logits.float(), dim=1)
        threshold = _threshold(probs, labels, ignore_index, thresh, min_kept, factor, group)
        valid, gt_prob = _gt_prob(probs, labels, ignore_index)
        kept = valid & (gt_prob <= threshold)
        del probs
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    ce = -torch.log_softmax(logits.float(), dim=1).gather(1, safe[:, None])[:, 0]
    total = torch.where(kept, ce, torch.zeros_like(ce)).sum()
    n_kept = kept.sum()
    if group is not None:
        (n_kept,) = all_reduce_sum([n_kept], group)
    return total / n_kept.clamp_min(1)


def criterion_ohem_dsn(preds: tuple, labels: torch.Tensor, ignore_index: int = 255,
                       thresh: float = 0.7, min_kept: int = 100000,
                       dsn_weight: float = 0.4, group=None) -> torch.Tensor:
    """OHEM CE on the main head + dsn_weight · plain CE on the auxiliary
    head, both upsampled (align-corners, f32) to the label size."""
    h, w = labels.shape[1], labels.shape[2]
    main = resize_bilinear_align_corners(preds[0].float(), (h, w))
    aux = resize_bilinear_align_corners(preds[1].float(), (h, w))
    return (ohem_cross_entropy(main, labels, ignore_index, thresh, min_kept, group=group)
            + dsn_weight * cross_entropy_ignore(aux, labels, ignore_index, group))
