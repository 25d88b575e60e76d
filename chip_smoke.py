"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's whole-image eval path (`training/evaluate.py::evaluate_main`)
on the card at Cityscapes full resolution, in phases; each phase prints one
line and any failure ends the run with a non-zero exit:

  1. device: CUDA must be available; prints the card's name and power limit,
     the torch/CUDA versions and the TF32 flags as set;
  2. build: compiles csrc/*.cu with nvcc (ops/_build.py) and prints the time;
  3. kernel: upsampled_argmax (K1) against upsampled_argmax_plain on the card
     at the eval path's shapes, f32 and bf16, plain and quantised (tied)
     logits; mismatches must be < 1e-3 of the pixels and true ties (< 1e-5);
     prints warm median times from CUDA events;
  4. slice: the full-width ResNet-18 PSPNet student with seeded weights runs
     evaluate_main over 4 synthetic 1024×2048 frames; mIoU must be finite in
     [0, 1], the confusion must count every in-bounds non-ignore pixel, and
     the kernel must have launched once per frame;
  5. GPU vs CPU: the same student and frame on cuda and cpu with TF32 off;
  6. teacher: one frame of the full-width ResNet-101 PSPNet through the same
     make_fast_val_fn.

The last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.models import student_model, teacher_model
from structure_knowledge_distillation_tpu_torch.ops import _build
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    upsampled_argmax,
    upsampled_argmax_plain,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    evaluate_main,
    make_fast_val_fn,
)

FULL_RES = (1024, 2048)
NUM_CLASSES = 19
FRAMES = 4
# K1 vs its plain version: the two sum the same two-tap products in another
# order, so they may disagree only where two classes tie
MISMATCH_SHARE_MAX = 1e-3
TIE_GAP_MAX = 1e-5
# GPU vs CPU forward in full f32 (TF32 off): cuDNN and the CPU's convolutions
# accumulate in different orders through ~20 layers
LOGITS_REL_TOL = 1e-3
CLASS_MAP_AGREEMENT_MIN = 0.999


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, sort_keys=False), flush=True)


def cuda_median_ms(fn, reps: int = 20, trials: int = 5) -> float:
    """Device time of one `fn()` in ms: the median over `trials` of CUDA
    events around `reps` back-to-back calls. Each trial first queues ~10 ms
    of device sleep, so all `reps` calls are enqueued before the device
    reaches them and the host's launch overhead stays out of the number (in
    the eval path the forward's device work hides it the same way)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def randomize_bn_stats(model: torch.nn.Module, seed: int) -> None:
    """Random running statistics, so eval-mode ABN does real work."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))


def phase_device() -> None:
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false: this smoke run needs a GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    smi_line = smi.stdout.strip().splitlines()[0]
    print(smi_line, flush=True)
    phase(1, "device", nvidia_smi=smi_line, kind=torch.cuda.get_device_name(0),
          capability=list(torch.cuda.get_device_capability(0)),
          count=torch.cuda.device_count(), torch=torch.__version__, cuda=torch.version.cuda,
          matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32,
          cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
          float32_matmul_precision=torch.get_float32_matmul_precision())


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_kernels()
    took = time.perf_counter() - t0
    ptxas = [ln.strip() for ln in _build.build_log().splitlines()
             if "registers" in ln or "spill" in ln or "built in" in ln]
    phase(2, "build", seconds=round(took, 3), nvcc=ptxas)


def phase_kernel(device: torch.device) -> dict:
    g = torch.Generator().manual_seed(1234)
    cases, max_gap, headline = [], 0.0, None
    for shape, out in (((1, NUM_CLASSES, 129, 257), FULL_RES),
                       ((2, NUM_CLASSES, 65, 65), (512, 512))):
        for dtype in (torch.float32, torch.bfloat16):
            for quantised in (False, True):
                x = torch.randn(shape, generator=g)
                if quantised:  # coarse grid: many exact ties after interpolation
                    x = torch.round(x * 2.0) / 2.0
                x = x.to(device=device, dtype=dtype).contiguous()
                k = upsampled_argmax(x, out)
                p = upsampled_argmax_plain(x, out)
                torch.cuda.synchronize()
                diff = k != p
                share = diff.float().mean().item()
                gap = 0.0
                if diff.any():
                    up = resize_bilinear_align_corners(x.float(), out)
                    vk = up.gather(1, k.long()[:, None])[:, 0][diff]
                    vp = up.gather(1, p.long()[:, None])[:, 0][diff]
                    gap = (vk - vp).abs().max().item()
                name = f"{tuple(shape)}->{out} {str(dtype)[6:]}{' quantised' if quantised else ''}"
                check(share < MISMATCH_SHARE_MAX, f"K1 {name}: mismatch share {share}")
                check(gap < TIE_GAP_MAX, f"K1 {name}: a mismatch is no tie (gap {gap})")
                max_gap = max(max_gap, gap)
                ms = cuda_median_ms(lambda: upsampled_argmax(x, out))
                plain_ms = cuda_median_ms(lambda: upsampled_argmax_plain(x, out))
                cases.append({"case": name, "mismatch": share, "tie_gap": gap,
                              "ms": ms, "plain_ms": plain_ms})
                if headline is None:  # (1,19,129,257)->(1024,2048) f32: the eval path's
                    headline = {"ms": ms, "plain_ms": plain_ms}
    phase(3, "kernel", cases=cases)
    return {"max_abs_err": max_gap, **headline}


def phase_slice(device: torch.device) -> int:
    model = student_model(NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(0))
    randomize_bn_stats(model, 1)
    model.eval()
    ds = SyntheticSegDataset(FRAMES, FULL_RES, NUM_CLASSES, seed=0)
    frames = list(batch_iterator(ds, 1, shuffle=False, drop_last=False))
    expect = sum(int((b[1] != 255).sum()) for b in frames)  # every pixel is in bounds

    evaluate_main(model, frames[:1], NUM_CLASSES, out_size=FULL_RES, device=device)  # warm-up
    torch.cuda.synchronize()
    upsampled_argmax.launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    miou, _, conf = evaluate_main(model, frames, NUM_CLASSES, out_size=FULL_RES, device=device)
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = upsampled_argmax.launches

    check(math.isfinite(miou) and 0.0 <= miou <= 1.0, f"student mIoU {miou}")
    check(int(conf.sum()) == expect, f"confusion counts {int(conf.sum())} pixels, expected {expect}")
    check(launches == FRAMES, f"upsampled_argmax launched {launches} times for {FRAMES} frames")
    phase(4, "slice", model="student R18 full width f32", frames=FRAMES, miou=miou,
          ms_per_frame=1e3 * took / FRAMES, launches=launches,
          max_memory_allocated=torch.cuda.max_memory_allocated(device))
    return launches


def phase_gpu_vs_cpu(device: torch.device) -> None:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        gpu = student_model(NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(0))
        randomize_bn_stats(gpu, 1)
        cpu = student_model(NUM_CLASSES, device="cpu")
        cpu.load_state_dict({k: v.cpu() for k, v in gpu.state_dict().items()})
        gpu.eval()
        cpu.eval()
        image = SyntheticSegDataset(1, FULL_RES, NUM_CLASSES, seed=5)[0][0]
        x = torch.from_numpy(image).permute(2, 0, 1)[None].contiguous()
        with torch.no_grad():
            lg = gpu(x.to(device))[0]
            pred_gpu = upsampled_argmax(lg, FULL_RES).cpu()
            lc = cpu(x)[0]
            pred_cpu = upsampled_argmax(lc, FULL_RES)
        lg = lg.cpu()
        err = (lg - lc).abs().max().item()
        scale = lc.abs().max().item()
        agree = (pred_gpu == pred_cpu).float().mean().item()
        check(bool(torch.isfinite(lg).all()), "GPU logits are not finite")
        check(err <= LOGITS_REL_TOL * scale, f"GPU vs CPU logits: max |diff| {err} vs max |logit| {scale}")
        check(agree >= CLASS_MAP_AGREEMENT_MIN, f"GPU vs CPU class maps agree in {agree} of pixels")
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    phase(5, "gpu_vs_cpu", logits_max_abs_diff=err, logits_max_abs=scale,
          rel_tol=LOGITS_REL_TOL, class_map_agreement=agree)


def phase_teacher(device: torch.device) -> None:
    model = teacher_model(NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(model, 3)
    model.eval()
    fn = make_fast_val_fn(model, FULL_RES, NUM_CLASSES)
    image, label, _, _ = SyntheticSegDataset(2, FULL_RES, NUM_CLASSES, seed=7)[1]
    x = torch.from_numpy(image).permute(2, 0, 1)[None].contiguous().to(device)
    lab = torch.from_numpy(label.astype(np.uint8)).to(device)
    with torch.no_grad():
        fn(x, lab, *FULL_RES)  # warm-up
        torch.cuda.synchronize()
        upsampled_argmax.launches = 0
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        _, conf = fn(x, lab, *FULL_RES)
        conf = conf.cpu().numpy()
        took = time.perf_counter() - t0
    iu = np.diag(conf) / np.maximum(1.0, conf.sum(0) + conf.sum(1) - np.diag(conf))
    miou = float(iu.mean())
    check(math.isfinite(miou) and 0.0 <= miou <= 1.0, f"teacher mIoU {miou}")
    check(int(conf.sum()) == int((label != 255).sum()), "teacher confusion count is off")
    check(upsampled_argmax.launches == 1, f"teacher frame launched K1 {upsampled_argmax.launches} times")
    phase(6, "teacher", model="teacher R101 full width f32", miou=miou,
          ms_per_frame=1e3 * took, launches=upsampled_argmax.launches,
          max_memory_allocated=torch.cuda.max_memory_allocated(device))


def main() -> int:
    phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    k1 = phase_kernel(device)
    launches = phase_slice(device)
    phase_gpu_vs_cpu(device)
    phase_teacher(device)
    print(json.dumps({"kernels": [{
        "name": "upsampled_argmax",
        "route": "cuda",
        "source": "structure_knowledge_distillation_tpu_torch/csrc/upsampled_argmax.cu",
        "replaces": "structure_knowledge_distillation_tpu/ops/pallas_eval.py:87",
        "launches": launches,
        # for an argmax: the largest logit gap between the two classes chosen
        # where kernel and plain version disagree (0.0 where they never do)
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
