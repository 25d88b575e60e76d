"""Typed configuration mirroring the reference's flag surface.

Counterpart of `structure_knowledge_distillation_tpu/config.py`: the same
`TrainConfig` field names and defaults, and `from_args` with the same flag
spellings (reference utils/train_options.py:16-83), so reference-style
command lines carry over. One field is the port's own: `device` (`--device`,
default `cuda`; a host without CUDA needs `--device cpu`).

Resume (`S_resume`, `D_resume`, `last_step`), the loader workers
(`num_workers`), the decode cache (`decode_cache_dir`), the multi-step loop
(`unroll_steps`, one CUDA-graph replay per chunk on the card), the step
profiler (`profile_dir`, `profile_steps`), the OHEM task loss (`ohem`,
`ohem_thresh`, `ohem_min_kept`), the ESPNet-C student (`student_arch`
espnet), `remat`, the VOC and CamVid data sets and data parallelism
(`num_data_shards` ranks, one per card; `batch_size` stays the global
batch and must divide) are ported; the CamVid
BGR mean replaces the default `input_mean_bgr` when `data_set` is camvid,
as in the JAX package. Options
of the JAX package that the port has not ported raise `NotImplementedError`
naming their ROADMAP item when set to anything but their default; the
reference's GPU-era flags (`--gpu`, `--parallel`, `--is-training`,
`--recurrence`) stay accepted and ignored, and so does `stem_s2d`, a TPU
layout whose parameters are the plain conv's. `wire_format` auto narrows the
train batches to bf16 images (under bf16 compute) and uint8 labels, u8 sends
the images as their original bytes (a dataset of integer−mean frames only;
synthetic keeps bf16, as in the JAX package), f32 keeps them as the dataset
makes them. `scales`/`flip` select the in-training eval's multiscale+flip
sweep.

`TestConfig` is the JAX `TestConfig` (reference TrainOptionsForTest) with
the same `device` field.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["TestConfig", "TrainConfig", "str2bool"]

_NOT_PORTED = "ROADMAP 'Not ported' (a TPU measure)"


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


@dataclass
class TrainConfig:
    # dataset / task
    data_set: str = "cityscapes"  # cityscapes | voc | camvid | synthetic
    data_dir: str = ""
    data_list: str = "dataset/list/cityscapes/train.lst"
    val_data_list: str = "dataset/list/cityscapes/val.lst"
    classes_num: int = 19
    ignore_label: int = 255
    input_size: Tuple[int, int] = (512, 512)
    # programmatic default True, CLI store_true default False: the reference's
    # argparse semantics (train_options.py:34-37)
    random_scale: bool = True
    random_mirror: bool = True

    # checkpoints
    T_ckpt_path: str = ""
    S_ckpt_path: str = "./ckpt/save_path/Student"
    D_ckpt_path: str = "./ckpt/save_path/Discriminator"
    S_resume: bool = False
    D_resume: bool = False
    is_student_load_imgnet: bool = False
    student_pretrain_model_imgnet: str = ""
    snapshot_dir: str = "./snapshots/"
    log_path: str = "./ckpt/log/save_path"

    # optimization (reference defaults; run_train_val.sh uses wd 5e-4)
    batch_size: int = 8
    num_steps: int = 40000
    last_step: int = 0
    # accepted for reference-CLI compatibility; the loop is step-based
    start_epoch: int = 0
    epoch_nums: int = 1
    lr_g: float = 1e-2
    lr_d: float = 4e-4
    momentum: float = 0.9
    weight_decay: float = 1e-4
    power: float = 0.9

    # task-loss variant
    ohem: bool = False
    ohem_thresh: float = 0.7
    ohem_min_kept: int = 100000

    # distillation terms
    pi: bool = True
    pa: bool = True
    ho: bool = True
    lambda_pi: float = 10.0
    lambda_pa: float = 1.0
    lambda_d: float = 0.1
    lambda_gp: float = 10.0
    pool_scale: float = 0.5

    # adversarial
    adv_loss_type: str = "wgan-gp"  # wgan-gp | hinge
    imsize_for_adv: int = 65
    adv_conv_dim: int = 64
    preprocess_gan_mode: int = 1

    # model family
    student_arch: str = "resnet18"
    teacher_layers: Tuple[int, ...] = (3, 4, 23, 3)  # R101; smaller for smoke runs

    # knobs of the JAX package with no reference counterpart
    compute_dtype: str = "bfloat16"  # bfloat16 | float32 for conv compute
    fused_ce: str = "auto"  # auto/true: the upsampled-CE kernels on CUDA | false
    flat_sgd: bool = False
    remat: bool = False
    stem_s2d: bool = True
    wire_format: str = "auto"
    input_mean_bgr: Tuple[float, float, float] = (104.00698793, 116.66876762,
                                                  122.67891434)
    num_data_shards: int = 1
    num_model_shards: int = 1
    num_slices: int = 1
    num_spatial_shards: int = 1
    unroll_steps: int = 1
    decode_cache_dir: str = ""
    num_workers: int = 0
    seed: int = 0
    log_every: int = 10
    profile_dir: str = ""
    profile_steps: int = 5
    eval_every: int = 0  # 0 => reference schedule (last 1000 steps, every 2975/batch)
    best_mean_IU: float = 0.0
    scales: Tuple[float, ...] = (1.0,)
    flip: bool = False

    # the port's own: the torch device of the models and batches
    device: str = "cuda"

    _DATASET_MEAN_BGR = {"camvid": (105.39, 108.85, 110.44)}

    def __post_init__(self):
        default = type(self).__dataclass_fields__["input_mean_bgr"].default
        if (tuple(self.input_mean_bgr) == tuple(default)
                and self.data_set in self._DATASET_MEAN_BGR):
            self.input_mean_bgr = self._DATASET_MEAN_BGR[self.data_set]
        self._check_ported()

    def _check_ported(self) -> None:
        """Raise for every option the port has not ported yet."""
        if self.student_arch not in ("resnet18", "espnet"):
            raise ValueError(f"student_arch should be resnet18 or espnet, "
                             f"got {self.student_arch!r}")
        checks = (
            (max(self.num_model_shards, self.num_slices, self.num_spatial_shards) > 1,
             f"the JAX mesh's model, dcn and spatial axes (num_model_shards, num_slices, "
             f"num_spatial_shards) are {_NOT_PORTED}"),
            (self.flat_sgd, f"flat_sgd is {_NOT_PORTED}"),
        )
        for failing, why in checks:
            if failing:
                raise NotImplementedError(why)
        if self.num_data_shards < 1 or self.batch_size % self.num_data_shards:
            raise ValueError(f"the global batch {self.batch_size} is not divisible by "
                             f"num_data_shards {self.num_data_shards}")
        if self.unroll_steps < 1:
            raise ValueError(f"unroll_steps should be >= 1, got {self.unroll_steps}")
        if self.compute_dtype not in ("bfloat16", "float32"):
            raise ValueError(f"compute_dtype should be bfloat16 or float32, "
                             f"got {self.compute_dtype!r}")
        if self.adv_loss_type not in ("wgan-gp", "hinge"):
            raise ValueError("adv_loss_type should be wgan-gp or hinge")

    @property
    def eval_save_steps(self) -> int:
        # reference train_and_eval.py:18 — save_steps = 2975 // batch_size
        return max(2975 // self.batch_size, 1)

    def should_eval(self, step: int) -> bool:
        """Reference schedule (train_and_eval.py:27): eval in the final 1000
        steps every `eval_save_steps`, and at num_steps-1."""
        if self.eval_every:
            return step > 0 and step % self.eval_every == 0
        return (
            step > 1
            and step % self.eval_save_steps == 0
            and step > self.num_steps - 1000
        ) or step == self.num_steps - 1

    @classmethod
    def from_args(cls, argv: Optional[list] = None) -> "TrainConfig":
        p = argparse.ArgumentParser(description="knowledge-distillation (PyTorch/CUDA)")
        p.add_argument("--data-set", default=cls.data_set, type=str)
        p.add_argument("--data-dir", default=cls.data_dir, type=str)
        p.add_argument("--data-list", default=cls.data_list, type=str)
        p.add_argument("--val-data-list", default=cls.val_data_list, type=str)
        p.add_argument("--classes_num", default=cls.classes_num, type=int)
        p.add_argument("--ignore-label", default=cls.ignore_label, type=int)
        p.add_argument("--input-size", default="512,512", type=str)
        p.add_argument("--random-mirror", action="store_true")
        p.add_argument("--random-scale", action="store_true")
        p.add_argument("--T_ckpt_path", default=cls.T_ckpt_path, type=str)
        p.add_argument("--S_ckpt_path", default=cls.S_ckpt_path, type=str)
        p.add_argument("--D_ckpt_path", default=cls.D_ckpt_path, type=str)
        p.add_argument("--S_resume", default=False, type=str2bool)
        p.add_argument("--D_resume", default=False, type=str2bool)
        p.add_argument("--is-student-load-imgnet", default=False, type=str2bool)
        # accepted-and-ignored GPU-era flags of the reference scripts
        p.add_argument("--gpu", default="", type=str, help=argparse.SUPPRESS)
        p.add_argument("--parallel", default="", type=str, help=argparse.SUPPRESS)
        p.add_argument("--is-training", default="", type=str, help=argparse.SUPPRESS)
        p.add_argument("--recurrence", default=1, type=int, help=argparse.SUPPRESS)
        p.add_argument("--student-pretrain-model-imgnet", default="", type=str)
        p.add_argument("--snapshot-dir", default=cls.snapshot_dir, type=str)
        p.add_argument("--log-path", default=cls.log_path, type=str)
        p.add_argument("--batch-size", default=cls.batch_size, type=int)
        p.add_argument("--num-steps", default=cls.num_steps, type=int)
        p.add_argument("--last-step", default=0, type=int)
        p.add_argument("--start_epoch", default=0, type=int)
        p.add_argument("--epoch_nums", default=1, type=int)
        p.add_argument("--lr-g", default=cls.lr_g, type=float)
        p.add_argument("--lr-d", default=cls.lr_d, type=float)
        p.add_argument("--momentum", default=cls.momentum, type=float)
        p.add_argument("--weight-decay", default=cls.weight_decay, type=float)
        p.add_argument("--power", default=cls.power, type=float)
        p.add_argument("--pi", default=True, type=str2bool)
        p.add_argument("--pa", default=True, type=str2bool)
        p.add_argument("--ho", default=True, type=str2bool)
        p.add_argument("--lambda-pi", default=cls.lambda_pi, type=float)
        p.add_argument("--lambda-pa", default=cls.lambda_pa, type=float)
        p.add_argument("--lambda-d", default=cls.lambda_d, type=float)
        p.add_argument("--lambda-gp", default=cls.lambda_gp, type=float)
        p.add_argument("--pool-scale", default=cls.pool_scale, type=float)
        p.add_argument("--adv-loss-type", default=cls.adv_loss_type, type=str)
        p.add_argument("--imsize-for-adv", default=cls.imsize_for_adv, type=int)
        p.add_argument("--adv-conv-dim", default=cls.adv_conv_dim, type=int)
        p.add_argument("--preprocess-GAN-mode", dest="preprocess_gan_mode",
                       default=cls.preprocess_gan_mode, type=int)
        p.add_argument("--student-arch", default=cls.student_arch, type=str)
        p.add_argument("--teacher-layers", default="3,4,23,3", type=str)
        p.add_argument("--ohem", default=False, type=str2bool)
        p.add_argument("--ohem-thresh", default=cls.ohem_thresh, type=float)
        p.add_argument("--ohem-min-kept", default=cls.ohem_min_kept, type=int)
        p.add_argument("--compute-dtype", default=cls.compute_dtype, type=str)
        p.add_argument("--fused-ce", default=cls.fused_ce, type=str)
        p.add_argument("--flat-sgd", default=cls.flat_sgd, type=str2bool)
        p.add_argument("--remat", default=cls.remat, type=str2bool)
        p.add_argument("--stem-s2d", default=cls.stem_s2d, type=str2bool)
        p.add_argument("--wire-format", default=cls.wire_format, type=str,
                       choices=("auto", "u8", "f32"))
        p.add_argument("--num-data-shards", default=1, type=int)
        p.add_argument("--num-model-shards", default=1, type=int)
        p.add_argument("--num-slices", default=1, type=int)
        p.add_argument("--num-spatial-shards", default=1, type=int)
        p.add_argument("--unroll-steps", default=1, type=int)
        p.add_argument("--decode-cache-dir", default="", type=str)
        p.add_argument("--num-workers", default=0, type=int)
        p.add_argument("--seed", default=0, type=int)
        p.add_argument("--log-every", default=10, type=int)
        p.add_argument("--profile-dir", default=cls.profile_dir, type=str,
                       help="write a torch.profiler trace of steps [first+9, first+9+"
                            "profile_steps) here")
        p.add_argument("--eval-every", default=0, type=int)
        p.add_argument("--best-mean-IU", default=0.0, type=float)
        p.add_argument("--scales", default="1.0", type=str,
                       help="in-training val multi-scale avg, e.g. 0.75,1.0")
        p.add_argument("--flip", default=False, type=str2bool)
        p.add_argument("--device", default=cls.device, type=str,
                       help="torch device; a host without CUDA needs --device cpu")
        ns = p.parse_args(argv)
        h, w = map(int, ns.input_size.split(","))
        kwargs = {}
        field_names = {f.name for f in dataclasses.fields(cls)}
        for key, val in vars(ns).items():
            if key == "input_size":
                kwargs["input_size"] = (h, w)
            elif key == "teacher_layers":
                kwargs["teacher_layers"] = tuple(int(x) for x in val.split(","))
            elif key == "scales":
                kwargs["scales"] = tuple(float(s) for s in val.split(","))
            elif key in field_names:
                kwargs[key] = val
        return cls(**kwargs)


@dataclass
class TestConfig:
    """The test-set sweep's options: the JAX `TestConfig` (reference
    TrainOptionsForTest, train_options.py:86-94), the same fields, flags and
    defaults, plus `device` (`--device`, default `cuda`)."""

    __test__ = False  # not a pytest test class

    data_dir: str = ""
    data_list: str = "dataset/list/cityscapes/test.lst"
    resume_from: str = ""
    classes_num: int = 19
    output_dir: str = "outputs"
    whole: bool = True  # whole-image vs sliding-tile inference
    flip: bool = False  # flip-average
    scales: Tuple[float, ...] = (1.0,)  # multi-scale averaging
    data_set: str = "cityscapes"  # cityscapes | voc
    device: str = "cuda"

    @classmethod
    def from_args(cls, argv: Optional[list] = None) -> "TestConfig":
        p = argparse.ArgumentParser(description="knowledge-distillation test (PyTorch/CUDA)")
        p.add_argument("--data-set", default=cls.data_set, type=str)
        p.add_argument("--data-dir", default="", type=str)
        p.add_argument("--data-list", default=cls.data_list, type=str)
        p.add_argument("--resume-from", default="", type=str)
        p.add_argument("--classes_num", default=19, type=int)
        p.add_argument("--output-dir", default="outputs", type=str)
        p.add_argument("--whole", default=True, type=str2bool)
        p.add_argument("--flip", default=False, type=str2bool)
        p.add_argument("--scales", default="1.0", type=str,
                       help="comma-separated, e.g. 0.75,1.0,1.25")
        p.add_argument("--device", default=cls.device, type=str,
                       help="torch device; a host without CUDA needs --device cpu")
        kw = vars(p.parse_args(argv))
        kw["scales"] = tuple(float(s) for s in kw["scales"].split(","))
        return cls(**kw)
