"""Standalone val-set evaluation: checkpoint → mean IU + per-class IUs.

    python -m structure_knowledge_distillation_tpu_torch.cli.eval \
        --resume-from ./ckpt/CS_scenes_40000.pth \
        --data-dir ../cityscapes --data-list ../cityscapes/list/val.lst

Counterpart of `structure_knowledge_distillation_tpu/cli/eval.py`, with the
same flags plus `--device` (default `cuda`; a host without CUDA needs
`--device cpu`). Ported: the Cityscapes, VOC (505×505, 21 classes) and
CamVid (360×480, 11 classes) val sets (`--data-set`; a missing list is
generated from the tree), the ResNet-18 PSPNet and ESPNet-C students
(`--student-arch resnet18|espnet`) and every single-device sweep:
whole-image single-scale, multiscale+flip (`--scales 0.75,1.0,1.25 --flip
true`) and sliding tiles (`--whole false --tile-size 512,512`).
`--num-data-shards N` with `--whole true` and no `--output-dir` shards the
sweep over N ranks, one per card (`--device cpu`: N processes over gloo):
each rank decodes and runs its frame of every group of N, and the
confusion is all-reduced (`evaluate_sharded` with a process group; scales
and flip as given). In any other mode the flag is ignored with the JAX
CLI's warning and the sweep runs on one device. `--num-spatial-shards` > 1
is not ported (XLA's halo exchange) and raises.
The port reads `.pth` checkpoints only; a JAX `.msgpack` checkpoint crosses
over as the state dict that the JAX package's `export_torch_respspnet`
writes (R18), or that `training/checkpoint.py::espnet_state_dict_from_jax`
makes (ESPNet-C, the port's own names). Without `--resume-from` the student
keeps seeded random weights (seed 0).
"""

from __future__ import annotations

import argparse
import logging

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.data import (
    DATASET_EVAL_DEFAULTS,
    DATASETS,
    EvalShard,
    batch_iterator,
    ensure_list,
)
from structure_knowledge_distillation_tpu_torch.models import ESPNetC, student_model
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt_io
from structure_knowledge_distillation_tpu_torch.parallel import (
    backend_for,
    launch,
    rank_device,
    world_of,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    evaluate_main,
    evaluate_sharded,
)

log = logging.getLogger(__name__)

SPATIAL_ITEM = ("height-sharded eval (evaluate_spatial, XLA's halo exchange) is ROADMAP "
                "'Not ported'")


def str2bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


def build_student(arch: str, num_classes: int, device: torch.device) -> torch.nn.Module:
    """The R18 `ResPSPNet` or, for arch `espnet`, the ESPNet-C `ESPNetC`
    (p=2, q=8), with seeded random weights (seed 0) on `device`."""
    gen = torch.Generator().manual_seed(0)
    if arch == "espnet":
        return ESPNetC(num_classes, device=device, generator=gen)
    return student_model(num_classes, device=device, generator=gen)


def check_device_and_checkpoint(device: torch.device, path: str) -> None:
    """Raise for a CUDA device on a host without CUDA and for a JAX
    `.msgpack` checkpoint (the port reads `.pth` files only)."""
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device on this host; pass --device cpu")
    if path.endswith(".msgpack"):
        raise ValueError("the port reads .pth checkpoints only; convert a JAX "
                         ".msgpack with export_torch_respspnet and torch.save")


def load_student(num_classes: int, device: torch.device, resume_from: str,
                 arch: str = "resnet18") -> torch.nn.Module:
    """The student in eval mode on `device`: seeded random weights (seed 0),
    or a `.pth` state dict from `resume_from`: reference-named for the R18
    student (merged by intersection, as the JAX importer does), the port's
    own names for ESPNet-C (loaded strictly). A CUDA device without CUDA
    and a JAX `.msgpack` raise."""
    check_device_and_checkpoint(device, resume_from)
    model = build_student(arch, num_classes, device)
    if resume_from:
        sd = ckpt_io.load_torch_state_dict(resume_from)
        if arch == "espnet":
            model.load_state_dict(sd, strict=True)
        else:
            ckpt_io.load_reference_state_dict(model, sd)
    return model.eval()


def main(argv=None):
    p = argparse.ArgumentParser(description="val-set mIoU evaluation (PyTorch/CUDA)")
    p.add_argument("--data-set", default="cityscapes", type=str,
                   choices=sorted(DATASET_EVAL_DEFAULTS))
    p.add_argument("--data-dir", default="", type=str)
    p.add_argument("--data-list", default="dataset/list/cityscapes/val.lst", type=str)
    p.add_argument("--resume-from", default="", type=str)
    p.add_argument("--classes_num", default=0, type=int,
                   help="0 = dataset default (19/21/11)")
    p.add_argument("--student-arch", default="resnet18", type=str,
                   choices=("resnet18", "espnet"))
    p.add_argument("--output-dir", default="", type=str)
    p.add_argument("--whole", default=True, type=str2bool)
    p.add_argument("--flip", default=False, type=str2bool)
    p.add_argument("--scales", default="1.0", type=str)
    p.add_argument("--eval-size", default="", type=str,
                   help="H,W; empty = dataset default")
    p.add_argument("--tile-size", default="512,512", type=str,
                   help="H,W sliding tile for --whole false (reference input_size, "
                        "networks/evaluate.py:163)")
    p.add_argument("--num-data-shards", default=1, type=int)
    p.add_argument("--num-spatial-shards", default=1, type=int)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; a host without CUDA needs --device cpu")
    args = p.parse_args(argv)

    if args.num_spatial_shards > 1:
        raise NotImplementedError(SPATIAL_ITEM)
    if args.num_data_shards > 1 and args.whole and not args.output_dir:
        mean_iu, iu_array = launch(_sharded_sweep, args.num_data_shards, args,
                                   backend=backend_for(args.device))[0]
    else:
        if args.num_data_shards > 1:
            # don't let the user believe the sweep was sharded (the JAX CLI's rule)
            log.warning("shard flags ignored: data sharding supports only whole-image "
                        "modes without --output-dir; running single-device")
        mean_iu, iu_array = _sweep(args)
    print(f"meanIU: {mean_iu:.6f}")
    print("IU_array:", np.array2string(iu_array, precision=4))
    return mean_iu


def _sweep(args, group=None):
    """(mean IU, IU array) of the val sweep the flags select; with a process
    group, this rank's part of the sharded whole-image sweep."""
    device = rank_device(args.device, group)
    default_size, default_classes = DATASET_EVAL_DEFAULTS[args.data_set]
    out_h, out_w = (map(int, args.eval_size.split(","))
                    if args.eval_size else default_size)
    num_classes = args.classes_num or default_classes
    model = load_student(num_classes, device, args.resume_from, args.student_arch)

    data_list = ensure_list(args.data_set, args.data_dir, args.data_list)
    ds = DATASETS[args.data_set](args.data_dir, data_list, crop_size=(out_h, out_w),
                                 scale=False, mirror=False)
    scales = tuple(float(s) for s in args.scales.split(","))
    if group is not None:
        rank, world = world_of(group)
        loader = batch_iterator(EvalShard(ds, rank, world), 1, shuffle=False)
        mean_iu, iu_array, _ = evaluate_sharded(
            model, loader, num_classes, out_size=(out_h, out_w), batch=world, scales=scales,
            flip=args.flip, device=device, group=group)
        return mean_iu, iu_array
    loader = batch_iterator(ds, 1, shuffle=False, drop_last=False)
    mean_iu, iu_array, _ = evaluate_main(
        model, loader, num_classes, out_size=(out_h, out_w), eval_type="val",
        output_dir=args.output_dir or None, whole=args.whole,
        tile_size=tuple(map(int, args.tile_size.split(","))), scales=scales, flip=args.flip,
        device=device,
    )
    return mean_iu, iu_array


def _sharded_sweep(group, args):
    """One spawned rank of `--num-data-shards N`."""
    return _sweep(args, group)


if __name__ == "__main__":
    main()
