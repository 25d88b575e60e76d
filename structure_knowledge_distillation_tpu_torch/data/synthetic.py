"""Synthetic dataset with the CSDataSet output signature, for tests and smoke runs.

Counterpart of `structure_knowledge_distillation_tpu/data/synthetic.py`: the
same numpy draws from the same seed, so both packages see the same frames.
Each sample is (image HWC float32, label HW int32, size [h, w, 3], name).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["SyntheticSegDataset", "synthetic_batches"]


class SyntheticSegDataset:
    def __init__(self, length: int = 16, crop_size: Tuple[int, int] = (512, 512),
                 num_classes: int = 19, ignore_label: int = 255, seed: int = 0,
                 ignore_frac: float = 0.05):
        self.length = length
        self.crop = crop_size
        self.num_classes = num_classes
        self.ignore_label = ignore_label
        self.seed = seed
        self.ignore_frac = ignore_frac

    def __len__(self) -> int:
        return self.length

    def __getitem__(self, index: int):
        rng = np.random.default_rng(self.seed * 100003 + index)
        h, w = self.crop
        image = rng.normal(0.0, 60.0, (h, w, 3)).astype(np.float32)
        label = rng.integers(0, self.num_classes, (h, w)).astype(np.int32)
        mask = rng.random((h, w)) < self.ignore_frac
        label[mask] = self.ignore_label
        return image, label, np.array([h, w, 3]), f"synthetic_{index}"


def synthetic_batches(batch_size: int, steps: int, crop_size=(512, 512),
                      num_classes: int = 19, seed: int = 0):
    """`steps` batches of `batch_size` consecutive samples, stacked: (images
    NHWC float32, labels NHW int32), as the JAX `synthetic_batches`."""
    ds = SyntheticSegDataset(batch_size * steps, crop_size, num_classes, seed=seed)
    for s in range(steps):
        samples = [ds[s * batch_size + i] for i in range(batch_size)]
        yield np.stack([x[0] for x in samples]), np.stack([x[1] for x in samples])
