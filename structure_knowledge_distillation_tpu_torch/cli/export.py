"""Inference export: checkpoint -> (folded) state dict + metadata, and a
self-contained serving program.

    python -m structure_knowledge_distillation_tpu_torch.cli.export \
        --checkpoint ./ckpt/CS_scenes_40000.pth --output ./export/student_infer \
        --fold-bn --program-output ./export/student_serve.pt2

Counterpart of `structure_knowledge_distillation_tpu/cli/export.py`. It
loads a ResPSPNet checkpoint (`--arch resnet18|resnet101`; a `.pth`: a
reference-named state dict or the port's own student snapshot, merged by
intersection as `cli.eval` loads it; a JAX `.msgpack` raises), optionally
folds the eval-mode ABN statistics into the convs (`models/fold.py`; serve
the result with `ResPSPNet(fold_bn=True)`) and checks the folded forward
against the unfolded one on a random `--verify-size`² input (max |diff| over
max(max |logit|, 1) at most 1e-3, else it raises; TF32 is off for the
check). It writes `<output>.pth` (the folded or unfolded state dict, in the
port's names, where the JAX CLI writes `<output>.msgpack`) and
`<output>.json` with the JAX CLI's keys (`arch`, `classes_num`, `fold_bn`,
`source`, `fold_max_logit_diff`). `--torch-output` also writes the unfolded
reference-named state dict (what the JAX `export_torch_respspnet` writes).
`--device` (default `cuda`; a host without CUDA needs `--device cpu`) is
where the model runs.

`--program-output` also writes a self-contained serving program: a
`torch.export` `ExportedProgram` saved as a `.pt2`, weights inside, loadable
with nothing but torch:

    prog = torch.export.load("student_serve.pt2").module()
    with torch.no_grad():
        classmap = prog(image)   # (B, H, W, 3) raw BGR float32, on --device

It takes RAW (not mean-subtracted) BGR f32 images, the mean
(`--input-mean-bgr`) subtracted inside, as the JAX artifact does. `classmap`
returns the (B, H, W) uint8 trainId map: the forward, the f32 logits
resized with align corners to the input size, and a first-index argmax.
`logits` returns the stride-8 scores in NHWC, f32. The program holds plain
PyTorch ops (the resize as two matmuls, `torch.argmax`), not the argmax
kernel K1 of the eval fast path: a program that called the port's ctypes
library would need the port to load, as the JAX artifact holds XLA's resize
and argmax, not the Pallas kernel. It runs on the device it was exported on,
at its static input shape, from a `bn_fused=False` model (folded or not).

The JAX CLI's StableHLO flags map to these:
  --stablehlo-output PATH     -> --program-output PATH (a .pt2)
  --stablehlo-size H,W        -> --program-size H,W (default 1024,2048)
  --stablehlo-batch N         -> --program-batch N
  --stablehlo-mode M          -> --program-mode M (classmap | logits)
  --stablehlo-dtype D         -> --program-dtype D (float32 | bfloat16: the
                                 convs' compute dtype inside the program)
  --stablehlo-platforms P     -> --device (the program's device)
and the JSON's "stablehlo" section is "program" (path, mode, input shape,
dtype, device, bytes, export seconds).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time

import torch
import torch.nn as nn

from structure_knowledge_distillation_tpu_torch.cli.eval import check_device_and_checkpoint
from structure_knowledge_distillation_tpu_torch.models import (
    BASIC,
    BOTTLENECK,
    ResPSPNet,
    fold_bn_state_dict,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt_io

log = logging.getLogger(__name__)

ARCHS = {"resnet18": (BASIC, (2, 2, 2, 2)), "resnet101": (BOTTLENECK, (3, 4, 23, 3))}
FOLD_REL_TOL = 1e-3  # the JAX CLI's parity bound
DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


class ServingProgram(nn.Module):
    """Raw BGR f32 (B, H, W, 3) in: the mean subtracted, the model's forward,
    then (`classmap`) the align-corners resize of the f32 logits to `size`
    and a first-index argmax as uint8 (B, H, W), or (`logits`) the stride-8
    f32 scores as (B, h, w, C)."""

    def __init__(self, model: nn.Module, mean_bgr, size, mode: str):
        super().__init__()
        if mode not in ("classmap", "logits"):
            raise ValueError(f"unknown program mode {mode!r}")
        self.model = model
        device = next(model.parameters()).device
        self.register_buffer("mean", torch.tensor(mean_bgr, dtype=torch.float32, device=device))
        self.size = tuple(size)
        self.mode = mode

    def forward(self, image: torch.Tensor) -> torch.Tensor:
        x = (image - self.mean).permute(0, 3, 1, 2).contiguous()
        logits = self.model(x)[0].float()
        if self.mode == "logits":
            return logits.permute(0, 2, 3, 1).contiguous()
        up = resize_bilinear_align_corners(logits, self.size)
        return up.argmax(dim=1).to(torch.uint8)


@contextlib.contextmanager
def no_tf32():
    """f32 convolutions and matmuls in full f32 inside (TF32 rounds at 1e-3)."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags


def rel_logit_diff(ref: torch.Tensor, got: torch.Tensor) -> float:
    """The fold parity measure: max |ref − got| / max(max |ref|, 1), in f32."""
    ref, got = ref.float(), got.float()
    return float((ref - got).abs().max() / torch.clamp(ref.abs().max(), min=1.0))


def fold_parity(model: nn.Module, folded: nn.Module, size: int, device) -> float:
    """`rel_logit_diff` of the two models' logits on a seeded (1, 3, size,
    size) normal input, in f32 with TF32 off."""
    x = torch.randn((1, 3, size, size), generator=torch.Generator().manual_seed(1)).to(device)
    with torch.no_grad(), no_tf32():
        return rel_logit_diff(model(x)[0], folded(x)[0])


def export_program(model: nn.Module, path: str, size, batch: int, mode: str,
                   mean_bgr) -> dict:
    """Trace `ServingProgram(model, ...)` at (batch, H, W, 3) with
    `torch.export.export` and save it to `path`; returns the JSON section."""
    device = next(model.parameters()).device
    serve = ServingProgram(model, mean_bgr, size, mode).eval().requires_grad_(False)
    shape = (batch, *size, 3)
    t0 = time.perf_counter()
    with torch.no_grad():
        program = torch.export.export(serve, (torch.zeros(shape, device=device),),
                                      strict=False)
    program.example_inputs = None  # else saved: 25 MB of zeros at 1024×2048
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.export.save(program, path)
    return {"path": path, "mode": mode, "input": list(shape), "device": str(device),
            "dtype": str(model.dtype or torch.float32).replace("torch.", ""),
            "bytes": os.path.getsize(path), "seconds": time.perf_counter() - t0}


def main(argv=None):
    p = argparse.ArgumentParser(description="ResPSPNet inference export (PyTorch/CUDA)")
    p.add_argument("--checkpoint", required=True,
                   help=".pth: a reference-named state dict or the port's student snapshot")
    p.add_argument("--arch", default="resnet18", choices=tuple(ARCHS))
    p.add_argument("--classes-num", default=19, type=int)
    p.add_argument("--output", required=True,
                   help="output basename (writes <output>.pth + .json)")
    p.add_argument("--fold-bn", action="store_true",
                   help="fold eval-mode ABN into the convs (serve with fold_bn=True)")
    p.add_argument("--torch-output", default="",
                   help="also write the unfolded reference-named state dict .pth")
    p.add_argument("--verify-size", default=128, type=int,
                   help="input side length for the fold parity check")
    p.add_argument("--program-output", default="",
                   help="also write a self-contained torch.export serving program (.pt2)")
    p.add_argument("--program-size", default="1024,2048",
                   help="serving input H,W (static shapes)")
    p.add_argument("--program-batch", default=1, type=int)
    p.add_argument("--program-mode", default="classmap", choices=("classmap", "logits"))
    p.add_argument("--program-dtype", default="float32", choices=tuple(DTYPES),
                   help="conv compute dtype inside the program")
    p.add_argument("--input-mean-bgr", default="104.00698793,116.66876762,122.67891434",
                   help="BGR mean subtracted inside the program, which takes RAW images")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; a host without CUDA needs --device cpu")
    args = p.parse_args(argv)

    device = torch.device(args.device)
    check_device_and_checkpoint(device, args.checkpoint)
    block, layers = ARCHS[args.arch]

    def build(**kw) -> ResPSPNet:
        return ResPSPNet(block, layers, args.classes_num, device=device,
                         generator=torch.Generator().manual_seed(0), **kw).eval()

    model = build()
    ckpt_io.load_reference_state_dict(model, ckpt_io.load_torch_state_dict(args.checkpoint))
    out_sd, max_diff = model.state_dict(), None
    if args.fold_bn:
        out_sd = fold_bn_state_dict(out_sd)
        folded = build(fold_bn=True)
        folded.load_state_dict(out_sd, strict=True)
        max_diff = fold_parity(model, folded, args.verify_size, device)
        log.info("fold parity: max relative logit diff = %.3e", max_diff)
        if max_diff > FOLD_REL_TOL:
            raise RuntimeError(f"BN folding parity check failed ({max_diff})")

    ckpt_io.save_torch({k: v.detach().cpu() for k, v in out_sd.items()}, args.output + ".pth")
    meta = {"arch": args.arch, "classes_num": args.classes_num,
            "fold_bn": bool(args.fold_bn), "source": args.checkpoint}
    if max_diff is not None:
        meta["fold_max_logit_diff"] = max_diff
    with open(args.output + ".json", "w") as f:
        json.dump(meta, f)
    log.info("wrote %s.pth", args.output)

    if args.torch_output:
        ckpt_io.save_torch({k: v.detach().cpu() for k, v in model.state_dict().items()},
                           args.torch_output)
        log.info("wrote torch state_dict %s", args.torch_output)

    if args.program_output:
        serve_model = build(dtype=DTYPES[args.program_dtype], fold_bn=args.fold_bn)
        serve_model.load_state_dict(out_sd, strict=True)
        size = tuple(int(v) for v in args.program_size.split(","))
        mean = [float(v) for v in args.input_mean_bgr.split(",")]
        meta["program"] = export_program(serve_model, args.program_output, size,
                                         args.program_batch, args.program_mode, mean)
        with open(args.output + ".json", "w") as f:
            json.dump(meta, f)
        log.info("wrote serving program %s (%d bytes, %s)", args.program_output,
                 meta["program"]["bytes"], meta["program"]["device"])
    return args.output + ".pth"


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
