"""Cityscapes val dataset (host side, numpy).

Counterpart of the val half of `structure_knowledge_distillation_tpu/data/
cityscapes.py` (reference dataset/datasets.py:121-210):
  * `.lst` lines are "image_path<TAB>label_path" relative to the data root;
  * labels map labelId → trainId (34 → 19 + ignore 255);
  * images are BGR with the reference mean subtracted, padded with 0 (labels
    with ignore) up to the crop, then cropped at an offset drawn from a seeded
    rng — the same draws as the JAX package, which are 0 when the crop equals
    the frame (the val case).

Samples stay HWC float32 / HW int32 numpy arrays, as in the JAX package; the
eval loop moves them to the device and to NCHW there. Random scale and mirror
are train-time augmentation and raise until the trainer slice. Images decode
with cv2 when it is installed, else PIL, imported on first read.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "IMG_MEAN_BGR",
    "ID_TO_TRAINID_LUT",
    "id2trainid",
    "trainid2id",
    "CityscapesDataset",
    "batch_iterator",
]

AUGMENTATION_ITEM = ("random scale/mirror augmentation is ROADMAP Queue A "
                     "item 'trainer and CLI'")

# BGR mean, reference train_and_eval.py:10 / evaluate.py:21.
IMG_MEAN_BGR = np.array((104.00698793, 116.66876762, 122.67891434), dtype=np.float32)

_IGNORE = 255
# labelId -> trainId (reference datasets.py:146-151).
_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

ID_TO_TRAINID_LUT = np.full(256, _IGNORE, dtype=np.uint8)
for _k, _v in _ID_TO_TRAINID.items():
    ID_TO_TRAINID_LUT[_k] = _v

_TRAINID_TO_ID_LUT = np.zeros(256, dtype=np.uint8)
for _k, _v in _ID_TO_TRAINID.items():
    _TRAINID_TO_ID_LUT[_v] = _k


def id2trainid(label: np.ndarray) -> np.ndarray:
    """labelId (0..33) -> trainId (0..18 / 255), via LUT."""
    return ID_TO_TRAINID_LUT[label]


def trainid2id(label: np.ndarray) -> np.ndarray:
    """trainId -> labelId, for test-server submission PNGs."""
    return _TRAINID_TO_ID_LUT[label]


def _imread(path: str, gray: bool) -> np.ndarray:
    """Decode to BGR uint8 (HWC) or gray uint8 (HW) with cv2, else PIL."""
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding images needs cv2 or PIL; neither is installed") from e
    with Image.open(path) as im:
        if gray:
            return np.asarray(im.convert("L"))
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])


@dataclass
class _Record:
    img: str
    label: Optional[str]
    name: str


def _parse_lst(root: str, list_path: str, with_labels: bool) -> list:
    records = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            img_path = osp.join(root, parts[0])
            if with_labels:
                label_path = osp.join(root, parts[1])
                name = osp.splitext(osp.basename(parts[1]))[0]
            else:
                label_path = None
                name = osp.splitext(osp.basename(parts[0]))[0]
            records.append(_Record(img_path, label_path, name))
    return records


class CityscapesDataset:
    """Val dataset: mean subtraction, pad and crop (no augmentation)."""

    def __init__(
        self,
        root: str,
        list_path: str,
        crop_size: Tuple[int, int] = (512, 512),
        mean: np.ndarray = IMG_MEAN_BGR,
        scale: bool = False,
        mirror: bool = False,
        ignore_label: int = 255,
        seed: int = 0,
    ):
        if scale or mirror:
            raise NotImplementedError(AUGMENTATION_ITEM)
        self.records = _parse_lst(root, list_path, with_labels=True)
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.ignore_label = ignore_label
        self.rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        rec = self.records[index]
        image = _imread(rec.img, gray=False)
        label = id2trainid(_imread(rec.label, gray=True))
        size = np.array(image.shape)

        image = image.astype(np.float32) - self.mean
        img_h, img_w = label.shape
        pad_h = max(self.crop_h - img_h, 0)
        pad_w = max(self.crop_w - img_w, 0)
        if pad_h > 0 or pad_w > 0:
            image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
            label = np.pad(label, ((0, pad_h), (0, pad_w)),
                           constant_values=self.ignore_label)
        img_h, img_w = label.shape
        h_off = int(self.rng.integers(0, img_h - self.crop_h + 1))
        w_off = int(self.rng.integers(0, img_w - self.crop_w + 1))
        image = image[h_off:h_off + self.crop_h, w_off:w_off + self.crop_w]
        label = label[h_off:h_off + self.crop_h, w_off:w_off + self.crop_w]
        return (
            np.ascontiguousarray(image, np.float32),
            np.ascontiguousarray(label, np.int32),
            size,
            rec.name,
        )


def _stack(samples) -> tuple:
    cols = list(zip(*samples))
    return tuple(
        np.stack(col) if isinstance(col[0], np.ndarray) else list(col)
        for col in cols
    )


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True) -> Iterator[tuple]:
    """Serial host batcher producing stacked NHWC numpy batches, one pass in
    a seeded shuffled order (the JAX batcher's order for the same seed)."""
    n = len(dataset)
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(seed).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for start in range(0, end, batch_size):
        yield _stack([dataset[int(i)] for i in order[start:start + batch_size]])
