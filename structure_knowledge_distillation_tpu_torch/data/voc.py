"""Pascal VOC datasets (reference dataset/datasets.py:12-119).

Counterpart of `structure_knowledge_distillation_tpu/data/voc.py`. Lists are
bare ids (`data/lists.py::make_voc_lists`); images are
`JPEGImages/<id>.jpg`, labels `SegmentationClassAug/<id>.png` (class ids
0..20, 255 ignore). Train augmentation: random scale f ∈ {0.5, 0.6, …, 1.6},
mean subtraction (`VOC_MEAN`, 128 per channel), zero/ignore padding up to
the crop, random crop, random mirror, with the JAX package's draws in its
order (`data/cityscapes.py::augment`). `VOCTestDataset` is the label-less test
split: mean subtraction and zero padding up to the crop only.
"""

from __future__ import annotations

import os.path as osp
from typing import Optional, Tuple

import numpy as np

from structure_knowledge_distillation_tpu_torch.data.cityscapes import (
    _imread_color,
    _imread_gray,
    augment,
)

__all__ = ["VOC_MEAN", "VOCDataset", "VOCTestDataset"]

VOC_MEAN = np.array((128.0, 128.0, 128.0), dtype=np.float32)


def _read_ids(list_path: str) -> list:
    with open(list_path) as f:
        return [line.strip() for line in f if line.strip()]


class VOCDataset:
    """Train/val VOC; items are (image HWC float32, label HW int32, size,
    id). `max_iters` repeats the ids up to at least that many samples."""

    def __init__(self, root: str, list_path: str, max_iters: Optional[int] = None,
                 crop_size: Tuple[int, int] = (321, 321), mean: np.ndarray = VOC_MEAN,
                 scale: bool = True, mirror: bool = True, ignore_label: int = 255,
                 seed: int = 0):
        ids = _read_ids(list_path)
        if max_iters is not None and ids:
            ids = ids * int(np.ceil(float(max_iters) / len(ids)))
        self.records = [(osp.join(root, f"JPEGImages/{i}.jpg"),
                         osp.join(root, f"SegmentationClassAug/{i}.png"), i) for i in ids]
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.scale = scale
        self.mirror = mirror
        self.ignore_label = ignore_label
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        img_path, label_path, name = self.records[index]
        image = _imread_color(img_path)
        label = _imread_gray(label_path)
        size = np.array(image.shape)
        image, label = augment(self.rng, image, label, (self.crop_h, self.crop_w), self.mean,
                               12 if self.scale else None, 0.5, self.mirror, self.ignore_label)
        return (np.ascontiguousarray(image, np.float32),
                np.ascontiguousarray(label.astype(np.int32)), size, name)


class VOCTestDataset:
    """Test frames without labels; items are (image HWC float32, size, id)."""

    def __init__(self, root: str, list_path: str, crop_size: Tuple[int, int] = (505, 505),
                 mean: np.ndarray = VOC_MEAN):
        self.records = [(osp.join(root, f"JPEGImages/{i}.jpg"), i) for i in _read_ids(list_path)]
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        img_path, name = self.records[index]
        image = _imread_color(img_path)
        size = np.array(image.shape)
        image = image.astype(np.float32) - self.mean
        pad_h = max(self.crop_h - image.shape[0], 0)
        pad_w = max(self.crop_w - image.shape[1], 0)
        if pad_h > 0 or pad_w > 0:
            image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
        return np.ascontiguousarray(image, np.float32), size, name
