"""Test-set submission: checkpoint → labelId palette PNGs.

    python -m structure_knowledge_distillation_tpu_torch.cli.test \
        --resume-from ./ckpt/CS_scenes_40000.pth --data-dir ../cityscapes

Counterpart of `structure_knowledge_distillation_tpu/cli/test.py` (reference
test.py), with `TestConfig`'s flags plus `--device` (default `cuda`; a host
without CUDA needs `--device cpu`). Loads the student from a `.pth` (the port
reads no JAX `.msgpack`; without `--resume-from` it keeps seeded random
weights), runs full-resolution inference over the test list (generated from
the Cityscapes tree when the list file is missing) and writes one
trainId→labelId-remapped palette PNG per frame into `--output-dir`
(reference networks/evaluate.py:187-191). `--data-set voc` runs the VOC
test sweep instead: the frames padded to 505×505 and one PNG of class ids
(no remap) per test id. `--scales`/`--flip` run the multiscale+flip sweep,
`--whole false` sliding 512×512 tiles.
"""

from __future__ import annotations

import logging

import torch

from structure_knowledge_distillation_tpu_torch.cli.eval import load_student
from structure_knowledge_distillation_tpu_torch.config import TestConfig
from structure_knowledge_distillation_tpu_torch.data import (
    CityscapesTestDataset,
    VOCTestDataset,
    batch_iterator,
    ensure_list,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main

log = logging.getLogger(__name__)

OUT_SIZE = (1024, 2048)
VOC_OUT_SIZE = (505, 505)


def main(argv=None) -> None:
    cfg = TestConfig.from_args(argv)
    for key, val in vars(cfg).items():
        print(f"{key} : {val}")
    device = torch.device(cfg.device)
    model = load_student(cfg.classes_num, device, cfg.resume_from)
    data_list = ensure_list(cfg.data_set, cfg.data_dir, cfg.data_list)
    voc = cfg.data_set == "voc"
    out_size = VOC_OUT_SIZE if voc else OUT_SIZE
    test_cls = VOCTestDataset if voc else CityscapesTestDataset
    ds = test_cls(cfg.data_dir, data_list, crop_size=out_size)
    loader = batch_iterator(ds, 1, shuffle=False, drop_last=False)
    evaluate_main(model, loader, cfg.classes_num, out_size=out_size, eval_type="test",
                  output_dir=cfg.output_dir, whole=cfg.whole, scales=cfg.scales, flip=cfg.flip,
                  remap_train_ids=not voc, device=device)
    log.info("wrote submission PNGs to %s", cfg.output_dir)


if __name__ == "__main__":
    main()
