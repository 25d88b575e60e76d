"""Cityscapes list-file generation.

Counterpart of the Cityscapes half of `structure_knowledge_distillation_tpu/
data/lists.py`. The reference ships `dataset/list/cityscapes/{train,val,
test}.lst` with "image<TAB>label" lines relative to the data root; the lists
are generated here from the standard tree instead:

    leftImg8bit/{split}/{city}/*_leftImg8bit.png
    gtFine/{split}/{city}/*_gtFine_labelIds.png

The VOC and CamVid generators are ROADMAP Queue A item 7 and raise.
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

__all__ = ["make_cityscapes_lists", "ensure_list"]

_ITEM7 = "ROADMAP Queue A item 7 'VOC/CamVid/ESPNet'"


def ensure_list(data_set: str, data_dir: str, list_path: str) -> str:
    """Make a configured list path resolve out of the box: if `list_path` is
    missing but `data_dir` is a dataset root, generate the lists into
    `dirname(list_path)` and return the file for the split named in
    `list_path`, so reference-style invocations (`--data-list
    ./dataset/list/cityscapes/train.lst`) need no separate generation step."""
    if osp.isfile(list_path):
        return list_path
    if data_set in ("voc", "camvid"):
        raise NotImplementedError(f"{data_set} list generation is {_ITEM7}")
    if data_set not in ("cityscapes", "cityscape") or not data_dir or not osp.isdir(data_dir):
        return list_path  # the dataset loader raises its usual error
    written = make_cityscapes_lists(data_dir, osp.dirname(list_path) or ".")
    if osp.isfile(list_path):
        return list_path
    base = osp.basename(list_path)
    for split, path in written.items():
        if split in base:
            return path
    return list_path


def make_cityscapes_lists(root: str, out_dir: Optional[str] = None) -> dict:
    """Scan a Cityscapes root and write train/val/test .lst files; returns
    {split: path}. Test lines have no label column (the reference's
    test.lst)."""
    out_dir = out_dir or osp.join(root, "list")
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for split in ("train", "val", "test"):
        img_dir = osp.join(root, "leftImg8bit", split)
        if not osp.isdir(img_dir):
            continue
        lines = []
        for city in sorted(os.listdir(img_dir)):
            city_dir = osp.join(img_dir, city)
            for fname in sorted(os.listdir(city_dir)):
                if not fname.endswith("_leftImg8bit.png"):
                    continue
                rel_img = osp.join("leftImg8bit", split, city, fname)
                if split == "test":
                    lines.append(rel_img + "\n")
                else:
                    label = fname.replace("_leftImg8bit.png", "_gtFine_labelIds.png")
                    rel_label = osp.join("gtFine", split, city, label)
                    lines.append(f"{rel_img}\t{rel_label}\n")
        path = osp.join(out_dir, f"{split}.lst")
        with open(path, "w") as f:
            f.writelines(lines)
        written[split] = path
    return written

