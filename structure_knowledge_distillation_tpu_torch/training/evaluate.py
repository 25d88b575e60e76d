"""Evaluation: whole-image, multiscale+flip and sliding-tile prediction,
confusion matrix, mIoU, PNGs.

Counterpart of `structure_knowledge_distillation_tpu/training/evaluate.py`
(reference networks/evaluate.py), on one device, NCHW inside:
  * the fast val path (`make_fast_val_fn`, and `make_fast_val_batch_fn` for a
    group of frames): forward → fused align-corners upsample + first-index
    argmax (`upsampled_argmax`, the CUDA kernel K1 on a CUDA device) →
    in-bounds mask → confusion matrix on the device;
  * multiscale + flip (`make_msf_val_batch_fn`, `make_msf_val_fn`): per scale
    the image resized with the align-corners matrices, a forward, the logits
    upsampled to the output size in f32, a flipped forward averaged in;
    summed over scales (never divided), then argmax, mask and confusion;
  * sliding tiles (`make_sliding_val_fn`): overlapping tiles (overlap ⅓),
    each tile's logits upsampled to the tile size and accumulated in f32
    with a count divisor;
  * the host helpers `predict_sliding` and `predict_multiscale` (numpy, the
    reference's shape of the computation);
  * `evaluate_sharded`: the whole-image sweep in groups of `batch` frames,
    the tail group padded with masked slots; with a process group, each
    rank runs its slots of every group (`data.EvalShard`) and the confusion
    is all-reduced once at the end;
  * `evaluate_main`: every sweep, val (returns mIoU) or the label-less test
    sweep (palette PNGs of labelIds for the test server);
  * the u8 image wire (`input_mean`): frames cross as their original bytes
    (`data.prefetch.quantize_u8`) and get the mean subtracted again on the
    device, exact for unscaled, unpadded integer−mean frames.

IU = tp / max(1, pos + res − tp), averaged over classes. Frames cross to a
CUDA device through pinned host memory with non-blocking copies, and the
int64 confusion stays on the device until the end of a sweep.
"""

from __future__ import annotations

import os
from math import ceil
from typing import Callable, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.data.cityscapes import trainid2id
from structure_knowledge_distillation_tpu_torch.data.prefetch import quantize_u8, to_nchw
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import upsampled_argmax
from structure_knowledge_distillation_tpu_torch.parallel.data_parallel import (
    all_reduce_sum,
    world_of,
)
from structure_knowledge_distillation_tpu_torch.utils import spans

__all__ = [
    "get_palette",
    "confusion_matrix",
    "iu_from_confusion",
    "make_predictor",
    "make_fast_val_fn",
    "make_fast_val_batch_fn",
    "make_msf_val_batch_fn",
    "make_msf_val_fn",
    "make_sliding_val_fn",
    "predict_sliding",
    "predict_multiscale",
    "evaluate_main",
    "evaluate_sharded",
]


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


def _model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def _wire_mean(input_mean, device: torch.device) -> Optional[torch.Tensor]:
    """The u8 wire's mean as a (3, 1, 1) float32 tensor on `device`, made
    once per program; None for the f32 wire."""
    if input_mean is None:
        return None
    return torch.from_numpy(np.asarray(input_mean, np.float32).reshape(3, 1, 1)).to(device)


def _quantize_wire(image: np.ndarray, mean) -> np.ndarray:
    """Host side of the u8 eval wire: the train wire's one quantizer."""
    return quantize_u8(image, mean)


def _dequantize_wire(image: torch.Tensor, mean: Optional[torch.Tensor]) -> torch.Tensor:
    if image.dtype == torch.uint8 and mean is not None:
        return image.float() - mean
    return image


def _logits(model: torch.nn.Module, x: torch.Tensor) -> torch.Tensor:
    preds = model(x)
    return preds[0] if isinstance(preds, (tuple, list)) else preds


def make_predictor(model: torch.nn.Module, out_size: Tuple[int, int]) -> Callable:
    """The whole-image forward, `predict(images)`: the main head's logits of
    (N, 3, H, W) images, upsampled in f32 with align-corners to `out_size`
    through `ops/resize.py` (no K1), as the JAX `make_predictor`. The model
    must be in eval mode; the caller holds `torch.no_grad()`."""
    out_size = tuple(out_size)

    def predict(images: torch.Tensor) -> torch.Tensor:
        return resize_bilinear_align_corners(_logits(model, images).float(), out_size)

    return predict


def _mask_padding(labels: torch.Tensor, hs: torch.Tensor, ws: torch.Tensor,
                  ignore_label: int) -> torch.Tensor:
    """(B, H, W) labels with every row ≥ hs[b] and column ≥ ws[b] set to
    `ignore_label`: padding stays out of the confusion whatever the label
    holds there, and a slot with h = w = 0 counts nowhere."""
    h_out, w_out = labels.shape[-2:]
    rows = torch.arange(h_out, device=labels.device)[None, :, None] < hs[:, None, None]
    cols = torch.arange(w_out, device=labels.device)[None, None, :] < ws[:, None, None]
    return torch.where(rows & cols, labels, torch.full_like(labels, ignore_label))


def _sizes(h: int, w: int, device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame's valid (h, w) as (1,) tensors made on `device` (a fill, no
    host→device copy)."""
    return (torch.full((1,), int(h), dtype=torch.int64, device=device),
            torch.full((1,), int(w), dtype=torch.int64, device=device))


def _single(run_batch: Callable) -> Callable:
    """A batch program `run(images, labels, hs, ws)` at batch 1:
    `run(image (1, 3, H, W), label (H, W), h, w)` → ((H, W) class map, conf)."""

    def run(image: torch.Tensor, label: torch.Tensor, h: int, w: int):
        pred, conf = run_batch(image, label[None], *_sizes(h, w, label.device))
        return pred[0], conf

    return run


def make_fast_val_batch_fn(model: torch.nn.Module, out_size: Tuple[int, int],
                           num_classes: int, ignore_label: int = 255,
                           input_mean=None) -> Callable:
    """Forward + upsample-argmax + in-bounds mask + confusion for a group.

    `run(images, labels, hs, ws)` takes (B, 3, H_in, W_in) images (f32, or
    uint8 with `input_mean`), (B, H, W) labels and (B,) valid heights and
    widths on the model's device, and returns the (B, H, W) uint8 class maps
    and the (C, C) int64 confusion of the whole group; a slot with
    h = w = 0 (a padded tail slot) counts nowhere. On a CUDA device the
    upsample-argmax is one launch of K1 for the group (the JAX batch
    program computes the same function with a matmul resize and argmax).
    The model must be in eval mode; the caller holds `torch.no_grad()`."""
    out_size = tuple(out_size)
    mean = _wire_mean(input_mean, _model_device(model))

    def run(images, labels, hs, ws):
        logits = _logits(model, _dequantize_wire(images, mean))
        pred = upsampled_argmax(logits.contiguous(), out_size).to(torch.uint8)
        labels = _mask_padding(labels, hs, ws, ignore_label)
        return pred, confusion_matrix(pred, labels, num_classes, ignore_label)

    return run


def make_fast_val_fn(model: torch.nn.Module, out_size: Tuple[int, int],
                     num_classes: int, ignore_label: int = 255,
                     input_mean=None) -> Callable:
    """`make_fast_val_batch_fn` for one frame: `run(image, label, h, w)`
    takes an (1, 3, H_in, W_in) image (f32, or uint8 with `input_mean`) and
    an (H, W) label on the model's device and returns the (H, W) uint8
    class map and the (C, C) int64 confusion; rows ≥ h and columns ≥ w
    (padding) count as ignore, whatever the label holds there."""
    return _single(make_fast_val_batch_fn(model, out_size, num_classes, ignore_label,
                                          input_mean))


def make_msf_val_batch_fn(model: torch.nn.Module, out_size: Tuple[int, int],
                          num_classes: int, scales: Tuple[float, ...], flip: bool,
                          ignore_label: int = 255, input_mean=None) -> Callable:
    """Multiscale + flip eval of a group, `run(images, labels, hs, ws)` as
    `make_fast_val_batch_fn`'s. Per scale s the f32 image is resized to
    (int(round(H·s)), int(round(W·s))) (Python's round, half to even, as the
    JAX program) with the align-corners matrices, run through the model, and
    its logits upsampled to `out_size` in f32; with `flip` the forward of
    the image flipped along W, flipped back, is averaged in. The scales'
    maps are summed, never divided, then argmax (first index), mask and
    confusion. Upsampling and sums are plain torch, as the JAX program's
    are plain jnp."""
    scales = tuple(scales)
    out_size = tuple(out_size)
    mean = _wire_mean(input_mean, _model_device(model))

    def fwd(x):
        return resize_bilinear_align_corners(_logits(model, x).float(), out_size)

    def run(images, labels, hs, ws):
        x = _dequantize_wire(images, mean).float()
        ih, iw = x.shape[2], x.shape[3]
        total = None
        for s in scales:
            xs = x if s == 1.0 else resize_bilinear_align_corners(
                x, (int(round(ih * s)), int(round(iw * s))))
            up = fwd(xs)
            if flip:
                up = 0.5 * (up + fwd(xs.flip(3)).flip(3))
            total = up if total is None else total + up
        pred = total.argmax(dim=1).to(torch.uint8)
        labels = _mask_padding(labels, hs, ws, ignore_label)
        return pred, confusion_matrix(pred, labels, num_classes, ignore_label)

    return run


def make_msf_val_fn(model: torch.nn.Module, out_size: Tuple[int, int], num_classes: int,
                    scales: Tuple[float, ...], flip: bool, ignore_label: int = 255,
                    input_mean=None) -> Callable:
    """`make_msf_val_batch_fn` for one frame, `run(image, label, h, w)` as
    `make_fast_val_fn`'s."""
    return _single(make_msf_val_batch_fn(model, out_size, num_classes, scales, flip,
                                         ignore_label, input_mean))


def _tile_grid(extent: Tuple[int, int], tile_size: Tuple[int, int], overlap: float):
    """The reference's tile boxes (y1, y2, x1, x2) over an (H, W) extent: the
    stride is ceil(th · (1 − overlap)) along both axes (th for the columns
    too, as the reference), and an edge tile shifts back inside the image."""
    h, w = extent
    th, tw = tile_size
    stride = ceil(th * (1.0 - overlap))
    rows = int(ceil(max(h - th, 0) / stride) + 1)
    cols = int(ceil(max(w - tw, 0) / stride) + 1)
    for r in range(rows):
        for c in range(cols):
            x1, y1 = int(c * stride), int(r * stride)
            x2, y2 = min(x1 + tw, w), min(y1 + th, h)
            yield max(y2 - th, 0), y2, max(x2 - tw, 0), x2


def make_sliding_val_fn(model: torch.nn.Module, out_size: Tuple[int, int],
                        tile_size: Tuple[int, int], num_classes: int,
                        ignore_label: int = 255, input_mean=None,
                        overlap: float = 1.0 / 3.0) -> Callable:
    """Overlapping-tile eval of one frame, `run(image, label, h, w)` as
    `make_fast_val_fn`'s. Each tile (zero-padded up to the tile size where
    the image is shorter) goes through the model, its logits are upsampled
    to the tile size (not the output size, reference evaluate.py:71) and
    summed into an f32 map with a per-pixel count; the argmax of map / count
    is the class map. Geometry as `predict_sliding`."""
    th, tw = tile_size
    out_size = tuple(out_size)
    boxes = list(_tile_grid(out_size, tile_size, overlap))
    mean = _wire_mean(input_mean, _model_device(model))

    def run(image, label, h, w):
        x = _dequantize_wire(image, mean).float()
        full = torch.zeros((num_classes, *out_size), dtype=torch.float32, device=x.device)
        cnt = torch.zeros((1, *out_size), dtype=torch.float32, device=x.device)
        for y1, y2, x1, x2 in boxes:
            tile = x[:, :, y1:y2, x1:x2]
            pad_h, pad_w = th - (y2 - y1), tw - (x2 - x1)
            if pad_h or pad_w:
                tile = F.pad(tile, (0, pad_w, 0, pad_h))
            up = resize_bilinear_align_corners(_logits(model, tile.contiguous()).float(),
                                               (th, tw))[0]
            full[:, y1:y2, x1:x2] += up[:, : y2 - y1, : x2 - x1]
            cnt[:, y1:y2, x1:x2] += 1.0
        pred = (full / cnt).argmax(dim=0).to(torch.uint8)
        labels = _mask_padding(label[None], *_sizes(h, w, label.device), ignore_label)
        return pred, confusion_matrix(pred, labels, num_classes, ignore_label)

    return run


def predict_sliding(predict_tile: Callable, image: np.ndarray, tile_size: Tuple[int, int],
                    num_classes: int, overlap: float = 1.0 / 3.0) -> np.ndarray:
    """Overlapping-tile inference on the host (reference :70-104), numpy as
    the JAX helper: `image` (1, H, W, 3), `predict_tile(tile)` → (1, th, tw,
    C) logits of an (1, th, tw, 3) tile; returns the (H, W, C) float64
    average."""
    _, h, w, _ = image.shape
    th, tw = tile_size
    full = np.zeros((h, w, num_classes), np.float64)
    cnt = np.zeros((h, w, 1), np.float64)
    for y1, y2, x1, x2 in _tile_grid((h, w), tile_size, overlap):
        tile = image[:, y1:y2, x1:x2, :]
        pad_h, pad_w = th - tile.shape[1], tw - tile.shape[2]
        if pad_h or pad_w:
            tile = np.pad(tile, ((0, 0), (0, pad_h), (0, pad_w), (0, 0)))
        logits = np.asarray(predict_tile(tile))[0]
        full[y1:y2, x1:x2] += logits[: y2 - y1, : x2 - x1]
        cnt[y1:y2, x1:x2] += 1
    return full / cnt


def predict_multiscale(predict_whole: Callable, image: np.ndarray,
                       scales: Iterable[float] = (1.0,), flip: bool = False) -> np.ndarray:
    """Average logits over image scales, optional flip-average, on the host
    (reference :115-134), numpy as the JAX helper: `image` (1, H, W, 3) is
    zoomed with `scipy.ndimage.zoom` (order 1, align-corners bilinear),
    `predict_whole(img)` → (1, H, W, C) logits at the output size; returns
    the (H, W, C) mean over scales."""
    from scipy import ndimage

    total = None
    scales = list(scales)
    for scale in scales:
        if scale == 1.0:
            scaled = image
        else:
            scaled = ndimage.zoom(image, (1.0, scale, scale, 1.0), order=1, prefilter=False)
        probs = np.asarray(predict_whole(scaled))[0]
        if flip:
            flipped = np.asarray(predict_whole(scaled[:, :, ::-1, :]))[0]
            probs = 0.5 * (probs + flipped[:, ::-1, :])
        total = probs if total is None else total + probs
    return total / len(scales)


def _to_device(x: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on `device`; to a CUDA device through pinned memory with
    a non-blocking copy (the caching host allocator hands the pinned block
    out again only after the copy has read it)."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _narrow_labels(num_classes: int, ignore_label: int) -> bool:
    return num_classes <= 254 and ignore_label <= 255


def _write_png(pred: np.ndarray, output_dir: str, name: str) -> None:
    from PIL import Image as PILImage

    os.makedirs(output_dir, exist_ok=True)
    im = PILImage.fromarray(pred)
    im.putpalette(get_palette(256))
    im.save(os.path.join(output_dir, f"{name}.png"))


def evaluate_sharded(
    model: torch.nn.Module,
    loader: Iterable,
    num_classes: int,
    out_size: Tuple[int, int] = (1024, 2048),
    batch: int = 8,
    ignore_label: int = 255,
    input_mean=None,
    scales: Iterable[float] = (1.0,),
    flip: bool = False,
    device: Optional[torch.device | str] = None,
    group=None,
):
    """Whole-image val sweep in groups of `batch` frames (no PNGs). Returns
    (mean_IU, IU_array, confusion) as `evaluate_main`.

    The loader's items (of any batch size) are regrouped into groups of
    `batch`; the tail group is padded with copies of its last frame whose
    slots carry h = w = 0, so they count nowhere. One scale without flip
    runs `make_fast_val_batch_fn` (K1 once per group on the card),
    `scales`/`flip` run `make_msf_val_batch_fn`. `input_mean` selects the u8
    image wire. The int64 confusion stays on the device until the end.

    With a process `group` of `world` ranks (the JAX `sharding` over a
    `data` mesh), `batch` is the group of frames over all ranks, a multiple
    of `world`, and `loader` yields this rank's frames (`data.EvalShard`,
    which pads the tail group's slots with h = w = 0 and decodes only the
    rank's frames), batch/world a rank per group. The int64 confusion is
    all-reduced once at the end, so every rank returns the same mIoU, equal
    to the one-process sweep's."""
    scales = tuple(scales)
    device = torch.device(device) if device is not None else _model_device(model)
    _, world = world_of(group)
    if batch % world:
        raise ValueError(f"a group of {batch} frames does not split over {world} ranks")
    batch //= world
    if scales == (1.0,) and not flip:
        fn = make_fast_val_batch_fn(model, out_size, num_classes, ignore_label, input_mean)
    else:
        fn = make_msf_val_batch_fn(model, out_size, num_classes, scales, flip, ignore_label,
                                   input_mean)
    narrow = _narrow_labels(num_classes, ignore_label)
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    buf: list = []

    def flush() -> None:
        pad = batch - len(buf)
        images = np.stack([b[0] for b in buf] + [buf[-1][0]] * pad)
        labels = np.stack([b[1] for b in buf] + [buf[-1][1]] * pad)
        hs = np.array([b[2] for b in buf] + [0] * pad, np.int64)
        ws = np.array([b[3] for b in buf] + [0] * pad, np.int64)
        _, group_conf = fn(to_nchw(_to_device(images, device)), _to_device(labels, device),
                           _to_device(hs, device), _to_device(ws, device))
        conf.add_(group_conf)
        buf.clear()

    with torch.no_grad():
        for image, label, size, _ in loader:
            for i in range(image.shape[0]):
                # each frame narrowed once, as it arrives: a padded tail
                # group repeats the narrowed frame
                img, lab = np.asarray(image[i]), np.asarray(label[i])
                if input_mean is not None:
                    img = _quantize_wire(img, input_mean)
                if narrow:
                    lab = lab.astype(np.uint8)
                buf.append((img, lab, int(size[i][0]), int(size[i][1])))
                if len(buf) == batch:
                    flush()
        if buf:
            flush()
    if group is not None:
        (conf,) = all_reduce_sum([conf], group)
    conf_np = conf.cpu().numpy()
    mean_iu, iu = iu_from_confusion(conf_np)
    return mean_iu, iu, conf_np


def evaluate_main(
    model: torch.nn.Module,
    loader: Iterable,
    num_classes: int,
    out_size: Tuple[int, int] = (1024, 2048),
    eval_type: str = "val",
    output_dir: Optional[str] = None,
    whole: bool = True,
    tile_size: Tuple[int, int] = (512, 512),
    scales: Iterable[float] = (1.0,),
    flip: bool = False,
    ignore_label: int = 255,
    remap_train_ids: bool = True,
    input_mean=None,
    device: Optional[torch.device | str] = None,
):
    """One frame at a time. Returns (mean_IU, IU_array, confusion) for
    'val', (None, None, None) for any other `eval_type` (the test sweep).

    `loader` yields batch-1 tuples as `data.batch_iterator` makes them:
    (image NHWC float32, label NHW, size, name) for val, (image, size, name)
    for test. The sweep takes, as the JAX `evaluate_main`:
      * the fast path (`make_fast_val_fn`) for a whole-image, single-scale,
        unflipped val sweep;
      * the multiscale+flip program (`make_msf_val_fn`) for every other
        whole-image sweep, val or test;
      * the sliding-tile program (`make_sliding_val_fn`, `tile_size`) when
        `whole` is False.
    The test sweep has no labels: each frame counts in full against a zero
    label and its confusion is thrown away. With `output_dir` set, each
    class map is written there as a palette PNG, as labelIds
    (`trainid2id`) in the test sweep when `remap_train_ids`. `input_mean`
    selects the u8 image wire. `device` defaults to the model's; the int64
    confusion (numpy, rows = ground truth) comes back once, at the end.

    Host spans (`utils/spans.py`, while recording): per frame the root
    `eval.frame`, with the children `eval.next` (the loader's yield),
    `eval.wire` (the host's quantization and narrowing), `eval.to_device`
    (both arrays' `_to_device`: pinning and the copies' enqueue) and
    `eval.launch` (`run`: the forward, K1 and the confusion enqueued)."""
    scales = tuple(scales)
    out_size = tuple(out_size)
    device = torch.device(device) if device is not None else _model_device(model)
    if whole and scales == (1.0,) and not flip and eval_type == "val":
        run = make_fast_val_fn(model, out_size, num_classes, ignore_label, input_mean)
    elif whole:
        run = make_msf_val_fn(model, out_size, num_classes, scales, flip, ignore_label,
                              input_mean)
    else:
        run = make_sliding_val_fn(model, out_size, tuple(tile_size), num_classes,
                                  ignore_label, input_mean)
    narrow = _narrow_labels(num_classes, ignore_label)
    conf = torch.zeros((num_classes, num_classes), dtype=torch.int64, device=device)
    with torch.no_grad():
        for batch in spans.iterate(loader, "eval.frame", "eval.next"):
            with spans.span("eval.wire"):
                if eval_type == "val":
                    image, label, size, name = batch
                    h, w = int(size[0][0]), int(size[0][1])
                    lab = np.asarray(label[0])
                else:
                    image, size, name = batch
                    h, w = out_size
                    lab = np.zeros(out_size, np.uint8)
                image = np.asarray(image)
                if input_mean is not None:
                    image = _quantize_wire(image, input_mean)
                if narrow:
                    lab = lab.astype(np.uint8)
            # HWC on the host, NCHW on the device: the transpose runs there
            with spans.span("eval.to_device"):
                image_d, lab_d = to_nchw(_to_device(image, device)), _to_device(lab, device)
            with spans.span("eval.launch"):
                pred, frame_conf = run(image_d, lab_d, h, w)
                if eval_type == "val":
                    conf += frame_conf
            if output_dir is not None:
                out = pred.cpu().numpy()
                if eval_type == "test" and remap_train_ids:
                    out = trainid2id(out)
                _write_png(out, output_dir, name[0])
    if eval_type != "val":
        return None, None, None
    conf_np = conf.cpu().numpy()
    mean_iu, iu = iu_from_confusion(conf_np)
    return mean_iu, iu, conf_np
