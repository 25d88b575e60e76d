"""Dataset list-file generation.

Counterpart of `structure_knowledge_distillation_tpu/data/lists.py`, writing
the same files. The reference ships `dataset/list/cityscapes/{train,val,
test}.lst` ("image<TAB>label" lines relative to the data root) and
`dataset/list/voc/{train_aug,val}.txt` (bare ids); the lists are generated
here from the standard trees instead:

    cityscapes:  leftImg8bit/{split}/{city}/*_leftImg8bit.png
                 gtFine/{split}/{city}/*_gtFine_labelIds.png
    voc:         ImageSets/Segmentation/{train,val,test}.txt +
                 JPEGImages/ + SegmentationClassAug/ (or SegmentationClass/)
    camvid:      {split}/ + {split}annot/ (SegNet-style 360×480 tree)
"""

from __future__ import annotations

import os
import os.path as osp
from typing import Optional

__all__ = ["make_cityscapes_lists", "make_voc_lists", "make_camvid_lists", "ensure_list"]


def ensure_list(data_set: str, data_dir: str, list_path: str) -> str:
    """Make a configured list path resolve out of the box: if `list_path` is
    missing but `data_dir` is a dataset root, generate the lists into
    `dirname(list_path)` and return the file for the split named in
    `list_path`, so reference-style invocations (`--data-list
    ./dataset/list/cityscapes/train.lst`) need no separate generation step."""
    if osp.isfile(list_path):
        return list_path
    gen = {"cityscapes": make_cityscapes_lists, "cityscape": make_cityscapes_lists,
           "voc": make_voc_lists, "camvid": make_camvid_lists}.get(data_set)
    if gen is None or not data_dir or not osp.isdir(data_dir):
        return list_path  # the dataset loader raises its usual error
    written = gen(data_dir, osp.dirname(list_path) or ".")
    if osp.isfile(list_path):
        return list_path
    base = osp.basename(list_path)
    # the generated name can differ from the requested one (train_aug.txt)
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


def make_voc_lists(root: str, out_dir: Optional[str] = None) -> dict:
    """Write bare-id VOC list files (the reference's
    dataset/list/voc/{train_aug,val}.txt format, consumed by VOCDataset).

    Ids come from ImageSets/Segmentation/{train,val,test}.txt, filtered to
    those with an existing mask in SegmentationClassAug/ (preferred — the
    reference trained on the SBD-augmented set) or SegmentationClass/. The
    train list is named train_aug.txt when the Aug masks are present.
    """
    out_dir = out_dir or osp.join(root, "list")
    os.makedirs(out_dir, exist_ok=True)
    aug_dir = osp.join(root, "SegmentationClassAug")
    has_aug = osp.isdir(aug_dir)
    mask_dir = aug_dir if has_aug else osp.join(root, "SegmentationClass")
    sets_dir = osp.join(root, "ImageSets", "Segmentation")
    written = {}
    for split in ("train", "val", "test"):
        src = osp.join(sets_dir, f"{split}.txt")
        if not osp.isfile(src):
            continue
        with open(src) as f:
            ids = [line.strip() for line in f if line.strip()]
        if split != "test":  # test has no public masks
            ids = [i for i in ids if osp.isfile(osp.join(mask_dir, f"{i}.png"))]
        name = "train_aug" if (split == "train" and has_aug) else split
        path = osp.join(out_dir, f"{name}.txt")
        with open(path, "w") as f:
            f.writelines(i + "\n" for i in ids)
        written[split] = path
    return written


def make_camvid_lists(root: str, out_dir: Optional[str] = None) -> dict:
    """Write CamVid .lst files ("image<TAB>label", CamVidDataset format) from
    the SegNet-style tree: {train,val,test}/ images + {split}annot/ labels.

    The reference's CamVid/ESPNet rows (README.md:12-18) ran through an
    external codebase with this layout; scripts/run_camvid_espnet.sh consumes
    the generated lists.
    """
    out_dir = out_dir or osp.join(root, "list")
    os.makedirs(out_dir, exist_ok=True)
    written = {}
    for split in ("train", "val", "test"):
        img_dir = osp.join(root, split)
        ann_dir = osp.join(root, split + "annot")
        if not (osp.isdir(img_dir) and osp.isdir(ann_dir)):
            continue
        lines = []
        for fname in sorted(os.listdir(img_dir)):
            if not fname.lower().endswith((".png", ".jpg")):
                continue
            ann = osp.join(ann_dir, fname)
            if osp.isfile(ann):
                lines.append(f"{osp.join(split, fname)}\t"
                             f"{osp.join(split + 'annot', fname)}\n")
        path = osp.join(out_dir, f"{split}.lst")
        with open(path, "w") as f:
            f.writelines(lines)
        written[split] = path
    return written
