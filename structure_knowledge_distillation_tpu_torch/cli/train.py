"""Training entry point — counterpart of reference train_and_eval.py.

    python -m structure_knowledge_distillation_tpu_torch.cli.train \
        --data-set cityscapes --data-dir ../cityscapes --random-scale --random-mirror \
        --num-workers 4 --decode-cache-dir ./cache --batch-size 8 --num-steps 40000 \
        --T_ckpt_path ./ckpt/teacher.pth

Counterpart of `structure_knowledge_distillation_tpu/cli/train.py`, with the
same flags (see `config.py`) plus `--device` (default `cuda`; a host without
CUDA needs `--device cpu`). Data sets: `cityscapes`, `camvid` and `voc`
(the train list at `--input-size` with the reference's augmentation, the
val list at 1024×2048, 360×480 and 505×505; missing lists are generated
from the tree) and `synthetic` (no files needed). The CamVid ESPNet-C
recipe (scripts/run_camvid_espnet.sh):

    python -m structure_knowledge_distillation_tpu_torch.cli.train \
        --data-set camvid --data-dir ../camvid --student-arch espnet \
        --classes_num 11 --input-size 360,480 --imsize-for-adv 46 \
        --random-mirror --random-scale --batch-size 8 --pi true --pa true \
        --ho false --T_ckpt_path ./ckpt/camvid_teacher.pth

`--ohem true` trains on the OHEM task loss and `--remat true`
rematerialises the R18 student's residual blocks.

The teacher loads from a `.pth` (`--T_ckpt_path`), the student's ImageNet
init from `--student-pretrain-model-imgnet`, the discriminator with
`--D_resume true` from `--D_ckpt_path` (a state dict, or the `discriminator`
of the port's `model_best.pth.tar`). `--S_resume true` resumes from
`--S_ckpt_path` (a file, or its `model_best.pth.tar`), else from the newest
auto-resume file in `<snapshot_dir>/latest`, and trains only the steps left
of `--num-steps`. SIGTERM stops the run at the next step boundary with the
full state saved there.

Batches come from the host batcher (with `--num-workers` processes), are
narrowed to bf16 images under bf16 compute and uint8 labels (unless
`--wire-format f32`; `--wire-format u8` sends Cityscapes images as their
original bytes), and reach the device through `device_prefetch`. With
`--unroll-steps K > 1` they are stacked into chunks of K steps on the host
first (`chunk_batches`), so one pinned copy moves a chunk, and the trainer
runs each full chunk as one CUDA-graph replay on the card. `--profile-dir`
writes a `torch.profiler` trace of steps [first + 9, first + 9 +
`profile_steps`), a config field (5 by default) with no flag, as in the JAX
package.

`--num-data-shards N` trains data parallel on N ranks, one per card (`cuda:r`
over NCCL; with `--device cpu`, N processes over gloo): the command spawns
them (`parallel.launch`), or, started by a launcher that sets `WORLD_SIZE`
(torchrun), is one of them. `--batch-size` stays the global batch; each
rank loads only its slice of every global batch (`batch_iterator`'s
`num_shards`/`shard_index`) and its frames of the val sweep
(`data.EvalShard`). Rank 0 logs and writes the checkpoints; the command
returns rank 0's best mean IU.
"""

from __future__ import annotations

import itertools
import logging
import os
import sys
from typing import Optional

import torch
import torch.distributed as dist

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import (
    DATASET_EVAL_DEFAULTS,
    DATASETS,
    CityscapesDataset,
    EvalShard,
    SyntheticSegDataset,
    batch_iterator,
    cast_batches,
    chunk_batches,
    device_prefetch,
    ensure_list,
)
from structure_knowledge_distillation_tpu_torch.parallel import backend_for, join_group, launch
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt_io
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer
from structure_knowledge_distillation_tpu_torch.utils import log_init, save_args

log = logging.getLogger(__name__)


def build_datasets(cfg: TrainConfig):
    """(train, val) datasets of `cfg.data_set`: the train list at
    `input_size` with the reference's augmentation, the val list at the
    data set's eval size (`DATASET_EVAL_DEFAULTS`)."""
    if cfg.data_set == "synthetic":
        train = SyntheticSegDataset(length=cfg.num_steps * cfg.batch_size,
                                    crop_size=cfg.input_size, num_classes=cfg.classes_num,
                                    seed=cfg.seed)
        val = SyntheticSegDataset(length=2, crop_size=cfg.input_size,
                                  num_classes=cfg.classes_num, seed=cfg.seed + 1)
        return train, val
    if cfg.data_set not in DATASETS:
        raise ValueError(f"unknown data_set {cfg.data_set!r}")
    # reference-style default list paths (./dataset/list/<data set>/train.lst)
    # resolve by generating the lists from the dataset tree on first use
    cfg.data_list = ensure_list(cfg.data_set, cfg.data_dir, cfg.data_list)
    cfg.val_data_list = ensure_list(cfg.data_set, cfg.data_dir, cfg.val_data_list)
    cls = DATASETS[cfg.data_set]
    # the CamVid mean comes with the class's default; cfg.input_mean_bgr
    # already holds it for the u8 wire (TrainConfig.__post_init__)
    extra = ({"cache_dir": cfg.decode_cache_dir or None} if cls is CityscapesDataset else {})
    train = cls(cfg.data_dir, cfg.data_list, max_iters=cfg.num_steps * cfg.batch_size,
                crop_size=cfg.input_size, scale=cfg.random_scale, mirror=cfg.random_mirror,
                ignore_label=cfg.ignore_label, seed=cfg.seed, **extra)
    val = cls(cfg.data_dir, cfg.val_data_list, crop_size=DATASET_EVAL_DEFAULTS[cfg.data_set][0],
              scale=False, mirror=False, ignore_label=cfg.ignore_label, **extra)
    return train, val


def _resolve_snapshot(path: str, name: str = "model_best.pth.tar") -> Optional[str]:
    """An explicit checkpoint file, or `model_best.pth.tar` inside a directory
    (the reference resumes from `<ckpt_path>/model_best.pth.tar`,
    utils/utils.py:109-110, :134-135)."""
    if os.path.isfile(path):
        return path
    cand = os.path.join(path, name)
    return cand if os.path.isdir(path) and os.path.isfile(cand) else None


def load_initial_variables(cfg: TrainConfig):
    """(teacher, student, discriminator) state dicts to start from; None
    where there is nothing to load."""
    teacher = student = disc = None
    if cfg.T_ckpt_path:
        teacher = ckpt_io.load_torch_state_dict(cfg.T_ckpt_path)
        log.info("loaded teacher from %s", cfg.T_ckpt_path)
    if cfg.D_resume:
        # reference load_D_model (utils/utils.py:130-151): restore the GAN
        # discriminator so a continued run keeps its adversarial state
        path = _resolve_snapshot(cfg.D_ckpt_path)
        if path is None:
            log.info("D_resume: no checkpoint at %r", cfg.D_ckpt_path)
        else:
            sd, meta = ckpt_io.load_torch_checkpoint(path)
            disc = meta.get("discriminator", sd)  # the port's model_best: its D
            log.info("loaded discriminator from %s", path)
    if cfg.is_student_load_imgnet and cfg.student_pretrain_model_imgnet:
        student = ckpt_io.load_torch_state_dict(cfg.student_pretrain_model_imgnet)
        log.info("loaded student ImageNet init from %s", cfg.student_pretrain_model_imgnet)
    return teacher, student, disc


def _rank_main(group, argv) -> float:
    """One spawned rank of `--num-data-shards N`."""
    return main(argv)


def main(argv=None) -> float:
    argv = sys.argv[1:] if argv is None else list(argv)
    cfg = TrainConfig.from_args(argv)
    if (cfg.num_data_shards > 1 and not dist.is_initialized()
            and "WORLD_SIZE" not in os.environ):
        return launch(_rank_main, cfg.num_data_shards, argv,
                      backend=backend_for(cfg.device))[0]
    group = join_group(cfg.num_data_shards, cfg.device)
    lead = group is None or dist.get_rank(group) == 0
    if lead:
        log_init(cfg.log_path, cfg.data_set)
        for key, val in vars(cfg).items():
            log.info("%s : %s", key, val)
        save_args(cfg, os.path.join(cfg.log_path, "args.txt"))
    else:
        logging.basicConfig(level=logging.WARNING, force=True)

    train_ds, val_ds = build_datasets(cfg)
    trainer = KDTrainer(cfg, *load_initial_variables(cfg))
    if cfg.S_resume:
        snap = _resolve_snapshot(cfg.S_ckpt_path)
        if snap is not None:
            trainer.resume_from_snapshot(snap)
        else:
            trainer.try_resume()

    # data parallel: every rank draws the same order and loads its slice
    host_batches = batch_iterator(train_ds, cfg.batch_size, shuffle=True, seed=cfg.seed,
                                  num_workers=cfg.num_workers, num_shards=trainer.world,
                                  shard_index=trainer.rank)
    # a resumed or offset run trains only the REMAINING budget: the reference
    # loop is range(num_steps - last_step) after restoring (train_and_eval.py:
    # 20-22); the dataset holds num_steps batches
    host_iter = host_batches
    if trainer.state.step:
        host_iter = itertools.islice(host_batches, max(0, cfg.num_steps - trainer.state.step))
    # narrow the host→device wire: bf16 images are what the model's first op
    # makes of f32 ones; uint8 labels fit ≤ 254 classes + ignore 255;
    # --wire-format u8 sends the images' original bytes (the train step
    # subtracts the mean on the device), except on synthetic data, whose
    # images are not integer−mean (the JAX CLI's rule): bf16 there
    image_dtype, image_mean = None, None
    if cfg.wire_format == "u8" and cfg.data_set != "synthetic":
        image_dtype, image_mean = torch.uint8, cfg.input_mean_bgr
    elif cfg.wire_format != "f32" and cfg.compute_dtype == "bfloat16":
        image_dtype = torch.bfloat16
    label_dtype = (torch.uint8 if cfg.classes_num <= 254 and cfg.ignore_label <= 255
                   and cfg.wire_format != "f32" else None)
    if trainer.unroll > 1:
        # stack the chunks on the host, then one transfer per chunk; the
        # islice above still counts steps
        host_iter = chunk_batches(host_iter, trainer.unroll)
    train_iter = device_prefetch(cast_batches(host_iter, image_dtype, label_dtype, image_mean),
                                 trainer.device)
    if trainer.group is not None:
        val_ds = EvalShard(val_ds, trainer.rank, trainer.world)

    def val_loader():
        return batch_iterator(val_ds, 1, shuffle=False)

    eval_out_size = (cfg.input_size if cfg.data_set == "synthetic"
                     else DATASET_EVAL_DEFAULTS[cfg.data_set][0])
    try:
        best = trainer.fit(train_iter, val_loader, eval_out_size=eval_out_size)
    finally:
        # an early stop (SIGTERM) or the islice bound leaves the batcher
        # suspended inside its worker pool: close both ends
        train_iter.close()
        host_batches.close()
    if lead:
        log.info("training done; best mean_IU %.4f", best)
    return best


if __name__ == "__main__":
    main()
