"""Evaluation: whole-image prediction, confusion matrix, mIoU, PNGs.

Counterpart of `structure_knowledge_distillation_tpu/training/evaluate.py`
(reference networks/evaluate.py). Ported so far is the fast whole-image val
path, the one `cli/eval.py` and the trainer's in-training eval take: forward
→ fused align-corners upsample + first-index argmax (`upsampled_argmax`, the
CUDA kernel on a CUDA device) → in-bounds mask → confusion matrix on the
device → IU = tp / max(1, pos + res − tp), averaged over classes.

Multiscale/flip, sliding tiles, the sharded sweep, test-set PNGs and the u8
image wire raise `NotImplementedError` naming their ROADMAP item.
"""

from __future__ import annotations

import os
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import upsampled_argmax

__all__ = [
    "get_palette",
    "confusion_matrix",
    "iu_from_confusion",
    "make_fast_val_fn",
    "make_msf_val_batch_fn",
    "evaluate_main",
    "evaluate_sharded",
]

MSF_ITEM = "multiscale/flip eval is ROADMAP Queue A item 'msf/sliding/sharded eval'"
SLIDING_ITEM = "sliding-tile eval is ROADMAP Queue A item 'msf/sliding/sharded eval'"
SHARDED_ITEM = "the sharded val sweep is ROADMAP Queue A item 'msf/sliding/sharded eval'"
WIRE_ITEM = "the u8 image wire (input_mean) is ROADMAP Queue A item 'msf/sliding/sharded eval'"
TEST_ITEM = "test-set PNG sweeps are ROADMAP Queue A item 'cli/test.py'"


def get_palette(num_cls: int) -> list:
    """Standard PASCAL-style bit-interleaved palette (reference :40-61)."""
    palette = [0] * (num_cls * 3)
    for j in range(num_cls):
        lab = j
        i = 0
        while lab:
            palette[j * 3 + 0] |= ((lab >> 0) & 1) << (7 - i)
            palette[j * 3 + 1] |= ((lab >> 1) & 1) << (7 - i)
            palette[j * 3 + 2] |= ((lab >> 2) & 1) << (7 - i)
            i += 1
            lab >>= 3
    return palette


def confusion_matrix(pred: torch.Tensor, label: torch.Tensor, num_classes: int,
                     ignore_label: int = 255) -> torch.Tensor:
    """(C, C) int64 counts on the tensors' device, rows = ground truth,
    cols = prediction; pixels labelled `ignore_label` count nowhere.

    The JAX version scatters into float32, which stops counting exactly once
    a cell passes 2**24 pixels — a full Cityscapes val sweep (500 frames of
    2M pixels) passes it in its large classes. int64 counts stay exact."""
    label = label.reshape(-1).long()
    pred = pred.reshape(-1).long()
    valid = label != ignore_label
    # ignored pixels go to one spare bin past the C*C cells, dropped after
    idx = torch.where(valid, label * num_classes + pred,
                      torch.full_like(label, num_classes * num_classes))
    counts = torch.bincount(idx, minlength=num_classes * num_classes + 1)
    return counts[: num_classes * num_classes].reshape(num_classes, num_classes)


def iu_from_confusion(conf) -> Tuple[float, np.ndarray]:
    conf = np.asarray(conf, np.float64)
    pos = conf.sum(1)
    res = conf.sum(0)
    tp = np.diag(conf)
    iu = tp / np.maximum(1.0, pos + res - tp)
    return float(iu.mean()), iu


def make_fast_val_fn(model: torch.nn.Module, out_size: Tuple[int, int],
                     num_classes: int, ignore_label: int = 255,
                     input_mean=None) -> Callable:
    """Forward + upsample-argmax + in-bounds mask + confusion for one frame.

    `run(image, label, h, w)` takes an (1, 3, H_in, W_in) float32 image and an
    (H, W) label on the model's device, and returns the (H, W) uint8 class
    map and the (C, C) int64 confusion. Rows ≥ h and columns ≥ w (padding)
    count as ignore, whatever the label holds there. The model must be in
    eval mode; the caller holds `torch.no_grad()`.
    """
    if input_mean is not None:
        raise NotImplementedError(WIRE_ITEM)
    h_out, w_out = out_size

    def run(image: torch.Tensor, label: torch.Tensor, h: int, w: int):
        preds = model(image)
        logits = preds[0] if isinstance(preds, (tuple, list)) else preds
        pred = upsampled_argmax(logits.contiguous(), out_size)[0].to(torch.uint8)
        rows = torch.arange(h_out, device=label.device)[:, None] < h
        cols = torch.arange(w_out, device=label.device)[None, :] < w
        label = torch.where(rows & cols, label, torch.full_like(label, ignore_label))
        return pred, confusion_matrix(pred, label, num_classes, ignore_label)

    return run


def make_msf_val_batch_fn(*args, **kwargs):
    raise NotImplementedError(MSF_ITEM)


def evaluate_sharded(*args, **kwargs):
    raise NotImplementedError(SHARDED_ITEM)


def evaluate_main(
    model: torch.nn.Module,
    loader: Iterable,
    num_classes: int,
    out_size: Tuple[int, int] = (1024, 2048),
    eval_type: str = "val",
    output_dir: Optional[str] = None,
    whole: bool = True,
    scales: Iterable[float] = (1.0,),
    flip: bool = False,
    ignore_label: int = 255,
    input_mean=None,
    device: Optional[torch.device | str] = None,
):
    """Whole-image val sweep. Returns (mean_IU, IU_array, confusion).

    `loader` yields batch-1 (image NHWC float32, label NHW, size, name)
    tuples as `data.batch_iterator` makes them. `device` defaults to the
    model's. The confusion (int64 numpy, rows = ground truth) accumulates on
    the device and comes back once, at the end of the sweep. With
    `output_dir` set, each class map is written there as a palette PNG.
    """
    scales = tuple(scales)
    if eval_type != "val":
        raise NotImplementedError(TEST_ITEM)
    if not whole:
        raise NotImplementedError(SLIDING_ITEM)
    if scales != (1.0,) or flip:
        raise NotImplementedError(MSF_ITEM)
    if device is None:
        device = next(model.parameters()).device
    device = torch.device(device)
    fast_fn = make_fast_val_fn(model, tuple(out_size), num_classes, ignore_label,
                               input_mean=input_mean)
    narrow_labels = num_classes <= 254 and ignore_label <= 255
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    with torch.no_grad():
        for image, label, size, name in loader:
            h, w = int(size[0][0]), int(size[0][1])
            # HWC on the host, NCHW on the device: the transpose runs there
            img = torch.from_numpy(np.ascontiguousarray(image)).to(device)
            img = img.permute(0, 3, 1, 2).contiguous()
            lab = np.asarray(label[0])
            lab = torch.from_numpy(lab.astype(np.uint8) if narrow_labels else lab).to(device)
            pred, conf_frame = fast_fn(img, lab, h, w)
            conf += conf_frame
            if output_dir is not None:
                from PIL import Image as PILImage

                os.makedirs(output_dir, exist_ok=True)
                im = PILImage.fromarray(pred.cpu().numpy())
                im.putpalette(get_palette(256))
                im.save(os.path.join(output_dir, f"{name[0]}.png"))
    conf_np = conf.cpu().numpy()
    mean_iu, iu = iu_from_confusion(conf_np)
    return mean_iu, iu, conf_np
