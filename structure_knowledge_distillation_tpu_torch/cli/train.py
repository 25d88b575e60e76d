"""Training entry point — counterpart of reference train_and_eval.py.

    python -m structure_knowledge_distillation_tpu_torch.cli.train \
        --data-set synthetic --batch-size 8 --num-steps 40000 \
        --T_ckpt_path ./ckpt/teacher.pth

Counterpart of `structure_knowledge_distillation_tpu/cli/train.py`, with the
same flags (see `config.py`) plus `--device` (default `cuda`; a host without
CUDA needs `--device cpu`). Ported so far: `--data-set synthetic` (no files
needed); the teacher loads from a `.pth` (`--T_ckpt_path`) and the student's
ImageNet init from `--student-pretrain-model-imgnet`. Cityscapes, VOC and
CamVid training raise: their train halves are ROADMAP Queue A items 6
(Cityscapes augmentation and the prefetcher) and 7 (VOC, CamVid).
"""

from __future__ import annotations

import logging

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt_io
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

log = logging.getLogger(__name__)

DATASET_ITEM = ("training on {} is ROADMAP Queue A items 6 'Trainer and CLI' (Cityscapes "
                "train half, prefetcher) and 7 'VOC/CamVid/ESPNet'; use --data-set synthetic")


def build_datasets(cfg: TrainConfig):
    if cfg.data_set != "synthetic":
        raise NotImplementedError(DATASET_ITEM.format(cfg.data_set))
    train = SyntheticSegDataset(length=cfg.num_steps * cfg.batch_size,
                                crop_size=cfg.input_size, num_classes=cfg.classes_num,
                                seed=cfg.seed)
    val = SyntheticSegDataset(length=2, crop_size=cfg.input_size,
                              num_classes=cfg.classes_num, seed=cfg.seed + 1)
    return train, val


def main(argv=None) -> float:
    cfg = TrainConfig.from_args(argv)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s")
    for key, val in vars(cfg).items():
        log.info("%s : %s", key, val)

    train_ds, val_ds = build_datasets(cfg)
    teacher_state = (ckpt_io.load_torch_state_dict(cfg.T_ckpt_path)
                     if cfg.T_ckpt_path else None)
    student_state = None
    if cfg.is_student_load_imgnet and cfg.student_pretrain_model_imgnet:
        student_state = ckpt_io.load_torch_state_dict(cfg.student_pretrain_model_imgnet)
    trainer = KDTrainer(cfg, teacher_state, student_state)
    train_iter = batch_iterator(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed)
    best = trainer.fit(train_iter,
                       lambda: batch_iterator(val_ds, 1, shuffle=False, drop_last=False),
                       eval_out_size=cfg.input_size)
    log.info("training done; best mean_IU %.4f", best)
    return best


if __name__ == "__main__":
    main()
