"""CamVid dataset (11-class road scenes, 360×480).

Counterpart of `structure_knowledge_distillation_tpu/data/camvid.py`: the
dataset of the reference's CamVid/ESPNet rows. List lines are
"image_path<TAB>label_path" relative to the data root (`data/lists.py::
make_camvid_lists` writes them from the SegNet-style tree); labels are
trainIds 0..10 with the void class 11 mapped to the ignore label. Train
augmentation: random scale f ∈ {0.7, 0.8, …, 2.1}, BGR mean subtraction
(`CAMVID_MEAN`), zero/ignore padding up to the crop, random crop, random
mirror; the draws come from the dataset's seeded `np.random.Generator` in
the JAX package's order (scale, h_off, w_off, mirror), so both packages make
the same samples for one seed. Samples are (image HWC float32, label HW
int32, size, name), as `CityscapesDataset`'s.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from structure_knowledge_distillation_tpu_torch.data.cityscapes import (
    _imread_color,
    _imread_gray,
    _parse_lst,
    augment,
)

__all__ = ["CAMVID_MEAN", "CamVidDataset"]

CAMVID_MEAN = np.array((105.39, 108.85, 110.44), dtype=np.float32)  # BGR


class CamVidDataset:
    """Train/val CamVid; `max_iters` repeats the records up to at least that
    many samples, as `CityscapesDataset`'s. `void_class` (11) becomes
    `ignore_label`; None keeps every label as it is."""

    def __init__(self, root: str, list_path: str, max_iters: Optional[int] = None,
                 crop_size: Tuple[int, int] = (360, 480), mean: np.ndarray = CAMVID_MEAN,
                 scale: bool = True, mirror: bool = True, ignore_label: int = 255,
                 void_class: Optional[int] = 11, seed: int = 0):
        self.records = _parse_lst(root, list_path, with_labels=True)
        if max_iters is not None and self.records:
            reps = int(np.ceil(float(max_iters) / len(self.records)))
            self.records = self.records * reps
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.scale = scale
        self.mirror = mirror
        self.ignore_label = ignore_label
        self.void_class = void_class
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        rec = self.records[index]
        image = _imread_color(rec.img)
        label = _imread_gray(rec.label).astype(np.int32)
        if self.void_class is not None:
            label[label == self.void_class] = self.ignore_label
        size = np.array(image.shape)
        image, label = augment(self.rng, image, label,
                               (self.crop_h, self.crop_w), self.mean,
                               15 if self.scale else None, 0.7, self.mirror,
                               self.ignore_label)
        return (np.ascontiguousarray(image, np.float32),
                np.ascontiguousarray(label, np.int32), size, rec.name)
