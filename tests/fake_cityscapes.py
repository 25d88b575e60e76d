"""A small Cityscapes tree written from a seed, for the port's data and trainer
tests: `leftImg8bit/{split}/{city}/*_leftImg8bit.png` BGR noise and
`gtFine/{split}/{city}/*_gtFine_labelIds.png` labelIds drawn from 0..33."""

import os

import cv2
import numpy as np


def write_fake_cityscapes(root, splits=(("train", 3), ("val", 1)), size=(40, 60), seed=0):
    """Writes the PNGs under `root`; returns {split: [(image, label) paths relative
    to root]}."""
    rng = np.random.default_rng(seed)
    h, w = size
    out = {}
    for split, n in splits:
        out[split] = []
        for i in range(n):
            city = f"city{i % 2}"
            img = f"leftImg8bit/{split}/{city}/{city}_{i:06d}_000019_leftImg8bit.png"
            lab = f"gtFine/{split}/{city}/{city}_{i:06d}_000019_gtFine_labelIds.png"
            for rel, arr in ((img, rng.integers(0, 256, (h, w, 3), dtype=np.uint8)),
                             (lab, rng.integers(0, 34, (h, w)).astype(np.uint8))):
                os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
                assert cv2.imwrite(os.path.join(root, rel), arr)
            out[split].append((img, lab))
    return out


def write_list(root, pairs, name="train.lst"):
    path = os.path.join(root, name)
    with open(path, "w") as f:
        f.writelines(f"{img}\t{lab}\n" for img, lab in pairs)
    return path
