"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths on the card, in phases: the whole-image eval
path (`training/evaluate.py::evaluate_main`) at Cityscapes full resolution,
the Pi+Pa+Ho distillation train step (`training/trainer.py::KDTrainer.fit`)
at the reference recipe, both again with the fused ABN (`bn_fused=True`,
kernels K6–K8), and the conv3x3 probe (K9). Each phase prints one line and
any failure ends the run with a non-zero exit:

  1. device: CUDA must be available; prints the card's name and power limit,
     the torch/CUDA versions and the TF32 flags as set;
  2. build: compiles csrc/*.cu with nvcc (ops/_build.py) and prints the time;
  3. kernel: upsampled_argmax (K1) against upsampled_argmax_plain on the card
     at the eval path's shapes, f32 and bf16, plain and quantised (tied)
     logits; mismatches must be < 1e-3 of the pixels and true ties (< 1e-5),
     and the class map must equal a tap-wise oracle's (the kernel's order of
     roundings, in separate torch operations) everywhere; prints warm median
     times from CUDA events, with the two-call F.interpolate + argmax beside
     them. K1 is one block per (image, low-res row interval, column window)
     that stages two low-res rows, interpolates along H once per high-res
     row and along W once per pixel and class; at the eval shape in f32 it
     must be at least 20× faster than its plain version, and its ptxas
     report must show no spill;
  4. slice: the full-width ResNet-18 PSPNet student with seeded weights runs
     evaluate_main over 4 synthetic 1024×2048 frames; mIoU must be finite in
     [0, 1], the confusion must count every in-bounds non-ignore pixel, and
     the kernel must have launched once per frame;
  5. GPU vs CPU: the same student and frame on cuda and cpu with TF32 off;
  6. teacher: one frame of the full-width ResNet-101 PSPNet through the same
     make_fast_val_fn;
  7. ce_kernel: the upsampled-CE kernels K4/K5 (two heads) and K2/K3 (one
     head) against their plain versions at the train shape, (8,19,65,65)
     logits → (8,512,512) int32 labels (the train step's dtype), f32 and
     bf16, 5 % and 100 % ignored labels: loss within a relative 1e-5,
     low-res gradients within 1e-4 of their largest entry (f32) or one bf16
     ulp of it (bf16), two runs bit-identical; warm median device times,
     forward and forward+backward. Forward and backward share one tiling:
     a block per (image, low-res row interval, column window or segment)
     stages its two low-res rows once and interpolates along H once per
     high-res row; the forward then interpolates each class once per pixel
     into registers, four classes at a time, for the log-sum-exp and the
     picked logit. K4 (bf16, 5 % ignored) must be at least 10× and K5 at
     least 4× faster than its plain version, and the ptxas report of the
     forward's and backward's kernels must show no spill;
  8. train: KDTrainer.fit at the reference recipe (batch 8, 512² crops,
     bf16 convs, Pi+Pa+Ho, wgan-gp) with a seeded random full-width R101
     teacher and seeded R18 student and discriminator: 2 warm-up steps, then
     5 timed steps; every loss finite, student and D parameters changed, and
     K4 and K5 launched once per step;
  9. train_gpu_vs_cpu: one f32 step of the CPU tests' small configuration on
     cuda (TF32 off) and on cpu from the same weights and GP α: losses and
     parameter updates agree;
 10. bn_kernel: the fused-ABN kernels K6 (with train and eval scale/shift),
     K7 and K8 (training True and False) against their plain versions at the
     path's shapes (the stem, R18 layer4, the R101 layer4 eval), activations
     none, leaky_relu and elu, f32 and bf16: the f32 forward within 1e-6
     relative, the bf16 forward within one bf16 ulp, K7's sums within 1e-5
     of their largest entry, dx within 1e-5 of max|dx| (f32) or one bf16
     ulp of it (bf16), two runs bit-identical; warm median device times;
 11. train_fused: phase 8's setup with bn_fused=True teacher and student,
     through make_train_step (the function KDTrainer.fit calls); every loss
     finite, student and D parameters changed, K6 launched once per ABN of
     teacher and student per step, K7 and K8 once per student ABN. One more
     step records the shape, dtype and activation of every K6–K8 launch;
     each distinct call is timed once, and the line prints per kernel
     Σ launches × ms and Σ launches × bound_ms per step (`bn_per_step`);
 12. train_fused_gpu_vs_cpu: phase 9 with bn_fused=True on both devices;
 13. eval_fused: phase 4's student with bn_fused=True through evaluate_main;
     K6 launched once per ABN per frame, mIoU within 1e-3 of the unfused
     model's on the same weights and frames, class maps agree in ≥ 0.999;
     K6's sums per frame as phase 11's (`bn_per_frame`);
 14. conv3x3_probe: the JAX probe's main (scripts/bench_pallas_conv.py) on
     the card. K9 has two CUDA kernels, chosen by dtype and channel counts:
     at (8,256,256,64) bf16 → Cout 64 and 128 the tensor-core kernel
     (csrc/conv3x3_wgmma.cu, counted as K9-wgmma) must run, within 2⁻⁷ of
     max|out| of the plain version (cuDNN, TF32 off), bit-identical over two
     runs, and at least 10× faster than the direct kernel (csrc/conv3x3.cu,
     timed at the same shape through its C entry point); the f32 case (within
     1e-5) and a ragged bf16 case must run the direct kernel. Each case prints
     its route, ms, plain_ms, library_ms (one F.conv2d), bound_ms, what sets
     the bound and the share of it reached; the wgmma kernel's ptxas report
     must show no spill.

Every kernel's JSON entry carries `bound_ms`, the least time an H100 SXM
could take for the call (`card_bound`: its bytes over 3.35 TB/s or its
operations over the peak of their type, whichever is longer, counted from
this run's inputs), `bound_by`, and `library_ms`, the time of one PyTorch
call that computes the same function where one exists (else null). The
last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import inspect
import json
import math
import statistics
import subprocess
import sys
import time
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.models import (
    BASIC,
    BOTTLENECK,
    Discriminator,
    ResPSPNet,
    student_model,
    teacher_model,
)
from structure_knowledge_distillation_tpu_torch.ops import _build, fused_bn
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
    ABN,
    _moments,
    abn_normalize,
    abn_train,
)
from structure_knowledge_distillation_tpu_torch.ops.conv3x3 import _route, conv3x3, conv3x3_plain
from structure_knowledge_distillation_tpu_torch.ops.fused_bn import (
    abn_fused_eval,
    abn_fused_train,
    bn_act,
    bn_act_plain,
    bn_grad_input,
    bn_grad_input_plain,
    bn_grad_sums,
    bn_grad_sums_plain,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.taps import tap_tables
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    upsampled_argmax,
    upsampled_argmax_plain,
)
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import (
    upsampled_ce_loss,
    upsampled_ce_loss_dsn,
    upsampled_ce_loss_dsn_plain,
    upsampled_ce_loss_plain,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    evaluate_main,
    make_fast_val_fn,
)
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

FULL_RES = (1024, 2048)
NUM_CLASSES = 19
FRAMES = 4
# K1 vs its plain version: the two sum the same two-tap products in another
# order, so they may disagree only where two classes tie; against the
# tap-wise oracle (the kernel's order and roundings) the class maps are equal
MISMATCH_SHARE_MAX = 1e-3
TIE_GAP_MAX = 1e-5
K1_SPEEDUP_MIN = 20.0  # K1 against its plain version at the eval shape, f32
# GPU vs CPU forward in full f32 (TF32 off): cuDNN and the CPU's convolutions
# accumulate in different orders through ~20 layers
LOGITS_REL_TOL = 1e-3
CLASS_MAP_AGREEMENT_MIN = 0.999
# K2–K5 vs their plain versions: f32 sums in another order; in bf16 the
# gradient is one rounding of nearly the same f32 value
CE_LOSS_RTOL = 1e-5
CE_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
CE_FWD_SPEEDUP_MIN = 10.0  # K4 against its plain version, bf16, 5 % ignored
CE_BWD_SPEEDUP_MIN = 4.0  # K5 against its plain version, bf16, 5 % ignored
TRAIN_SHAPE = (8, NUM_CLASSES, 65, 65)
TRAIN_CROP = (512, 512)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# GPU vs CPU train step in f32 with TF32 off: the one-step envelope of the
# CPU parity tests (tests/test_torch_port_train_step.py)
STEP_LOSS_RTOL, STEP_LOSS_ATOL = 2e-3, 2e-4
STEP_UPDATE_REL_L2, STEP_UPDATE_COS, UPDATE_FLOOR = 2e-2, 0.999, 1e-4
# K6–K8 vs their plain versions: the same f32 operations in the same order
# (the ELU's expm1f aside); K7 sums in another order; the plain K8 divides
# by the slope as a multiplication by its reciprocal
BN_SHAPES = {"stem": (8, 64, 256, 256), "R18 layer4": (8, 512, 65, 65),
             "R101 layer4 eval": (8, 2048, 65, 65)}
BN_FWD_RTOL = 1e-6
BN_SUM_REL = 1e-5
BN_DX_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
BN_EPS = 1e-5
# the fused eval against the unfused one on the same weights and frames
EVAL_MIOU_ATOL = 1e-3
# K9 vs cuDNN (TF32 off): f32 sums in another order, then one bf16 rounding
CONV_SHAPE, CONV_COUTS = (8, 256, 256, 64), (64, 128)
CONV_RAGGED = ((2, 16, 40, 20), 40)  # bf16, but neither Cin nor Cout fits the wgmma kernel
CONV_REL = {torch.float32: 1e-5, torch.bfloat16: 2.0 ** -7}
CONV_SPEEDUP_MIN = 10.0  # the wgmma kernel against the direct one, same shape
# H100 SXM peaks (NVIDIA's data sheet, dense, at a 700 W limit): device
# memory, bf16 tensor cores, f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16 tensor": 989e12, "f32": 67e12}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(msg)


def phase(n: int, name: str, **fields) -> None:
    print(f"phase {n} {name}: " + json.dumps(fields, sort_keys=False), flush=True)


def card_bound(nbytes: float, flops: float, peak: str = "f32") -> dict:
    """The least time the card could take for a call that must move
    `nbytes` (each input read once, each output written once) and do `flops`
    operations at the peak rate of type `peak`: the longer of the two."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[peak]
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


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


# each kernel's launch count: (wrapper, attribute)
COUNTERS = {"K1": (upsampled_argmax, "launches"), "K2": (upsampled_ce_loss, "launches"),
            "K3": (upsampled_ce_loss, "bwd_launches"), "K4": (upsampled_ce_loss_dsn, "launches"),
            "K5": (upsampled_ce_loss_dsn, "bwd_launches"), "K6": (bn_act, "launches"),
            "K7": (bn_grad_sums, "launches"), "K8": (bn_grad_input, "launches"),
            "K9": (conv3x3, "launches"), "K9-wgmma": (conv3x3, "wgmma_launches")}


def zero_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {k: getattr(fn, attr) for k, (fn, attr) in COUNTERS.items()}


def randomize_bn_stats(model: torch.nn.Module, seed: int) -> None:
    """Random running statistics, so eval-mode ABN does real work."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, buf in model.named_buffers():
            if name.endswith("running_mean"):
                buf.copy_(0.1 * torch.randn(buf.shape, generator=g))
            elif name.endswith("running_var"):
                buf.copy_(0.5 + torch.rand(buf.shape, generator=g))


def randomize_affine(model: torch.nn.Module, seed: int) -> None:
    """The CPU parity tests' randomisation: signed BN weights (a quarter
    negative, so |w| + eps matters), small BN and conv biases, non-zero
    attention gammas, and random running statistics."""
    g = torch.Generator().manual_seed(seed)
    randomize_bn_stats(model, seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() != 1:
                continue
            if name.endswith("gamma"):
                p.copy_(0.5 * torch.rand(p.shape, generator=g))
            elif name.endswith("weight"):
                sign = torch.where(torch.rand(p.shape, generator=g) < 0.25, -1.0, 1.0)
                p.copy_(sign * (torch.rand(p.shape, generator=g) + 0.5))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=g))


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


def ptxas_report() -> list:
    """Each compiled kernel's registers and spills from nvcc's ptxas output
    (`_build.build_log`): [{"function", "registers", "spill_stores",
    "spill_loads"}] in build order."""
    report = []
    for ln in _build.build_log().splitlines():
        if "Compiling entry function" in ln:
            report.append({"function": ln.split("'")[1]})
        elif report and "bytes spill stores" in ln:
            words = ln.replace(",", "").split()
            report[-1]["spill_stores"] = int(words[words.index("spill") - 2])
            report[-1]["spill_loads"] = int(words[-4])
        elif report and "Used" in ln and "registers" in ln:
            words = ln.replace(",", " ").split()
            report[-1]["registers"] = int(words[words.index("registers") - 1])
    return report


def phase_build() -> None:
    t0 = time.perf_counter()
    _build.load_kernels()
    took = time.perf_counter() - t0
    built = [ln.strip() for ln in _build.build_log().splitlines() if "built in" in ln]
    phase(2, "build", seconds=round(took, 3), nvcc=built, ptxas=ptxas_report())


def _tapwise_argmax(x: torch.Tensor, out) -> torch.Tensor:
    """K1's arithmetic tap by tap in separate torch operations on the card:
    the two row taps interpolated along H, then the two column taps along W
    (each product and sum its own kernel, rounded on its own), then the
    first-index argmax over classes."""
    n, c, h_in, w_in = x.shape
    (ylo, yhi), (wy0, wy1) = (torch.from_numpy(a).to(x.device) for a in tap_tables(h_in, out[0]))
    (xlo, xhi), (wx0, wx1) = (torch.from_numpy(a).to(x.device) for a in tap_tables(w_in, out[1]))
    xf = x.float()
    v = xf[:, :, ylo.long()] * wy0[:, None] + xf[:, :, yhi.long()] * wy1[:, None]
    u = v[..., xlo.long()] * wx0 + v[..., xhi.long()] * wx1
    return u.argmax(dim=1).to(torch.int32)


def phase_kernel(device: torch.device) -> dict:
    # one instantiation per dtype
    k1_ptxas = [k for k in ptxas_report() if "upsampled_argmax" in k["function"]]
    check(len(k1_ptxas) == 2 and
          all(k["spill_stores"] == k["spill_loads"] == 0 for k in k1_ptxas),
          f"K1's ptxas report: {k1_ptxas}")
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
                oracle_diff = int((k != _tapwise_argmax(x, out)).sum())
                check(oracle_diff == 0, f"K1 {name}: {oracle_diff} pixels differ from the "
                                        f"tap-wise oracle")
                max_gap = max(max_gap, gap)
                ms = cuda_median_ms(lambda: upsampled_argmax(x, out))
                plain_ms = cuda_median_ms(lambda: upsampled_argmax_plain(x, out))
                # what a user would otherwise write: two calls, the upsampled
                # logits in between (not the same function: torch's resize
                # rounds in its own order)
                interp_argmax_ms = cuda_median_ms(lambda: F.interpolate(
                    x, out, mode="bilinear", align_corners=True).argmax(1))
                cases.append({"case": name, "mismatch": share, "tie_gap": gap,
                              "oracle_mismatch": oracle_diff, "ms": ms, "plain_ms": plain_ms,
                              "speedup_vs_plain": plain_ms / ms,
                              "interpolate_argmax_ms": interp_argmax_ms})
                if headline is None:  # (1,19,129,257)->(1024,2048) f32: the eval path's
                    # separable resize (a lerp of 3 operations per sample,
                    # along H on the input's columns, then along W) and a
                    # compare per class and output pixel
                    n, c, h_in, w_in = shape
                    flops = n * c * out[0] * (3 * w_in + 3 * out[1] + out[1])
                    # no one PyTorch call upsamples and takes the argmax
                    headline = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                                **card_bound(x.nbytes + k.nbytes, flops)}
                    headline["bound_share"] = headline["bound_ms"] / ms
                    check(plain_ms >= K1_SPEEDUP_MIN * ms,
                          f"K1 {name}: {ms} ms is not {K1_SPEEDUP_MIN}x faster than the plain "
                          f"version's {plain_ms} ms")
    phase(3, "kernel", cases=cases, ptxas=k1_ptxas)
    return {"max_abs_err": max_gap, **headline}


def _eval_frames() -> list:
    ds = SyntheticSegDataset(FRAMES, FULL_RES, NUM_CLASSES, seed=0)
    return list(batch_iterator(ds, 1, shuffle=False, drop_last=False))


def _eval_student(device) -> ResPSPNet:
    """Phase 4's student: the full-width R18 with seeded weights and random
    running statistics, in eval mode."""
    model = student_model(NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(0))
    randomize_bn_stats(model, 1)
    return model.eval()


def _timed_eval(model, frames, device):
    """evaluate_main over `frames` after one warm-up frame, with every launch
    count set to 0 and the peak-memory counter reset just before the sweep:
    (mIoU, confusion, seconds, launch counts)."""
    evaluate_main(model, frames[:1], NUM_CLASSES, out_size=FULL_RES, device=device)  # warm-up
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    miou, _, conf = evaluate_main(model, frames, NUM_CLASSES, out_size=FULL_RES, device=device)
    torch.cuda.synchronize()
    return miou, conf, time.perf_counter() - t0, read_counts()


def phase_slice(device: torch.device) -> dict:
    model = _eval_student(device)
    frames = _eval_frames()
    expect = sum(int((b[1] != 255).sum()) for b in frames)  # every pixel is in bounds
    miou, conf, took, counts = _timed_eval(model, frames, device)
    launches = counts["K1"]

    check(math.isfinite(miou) and 0.0 <= miou <= 1.0, f"student mIoU {miou}")
    check(int(conf.sum()) == expect, f"confusion counts {int(conf.sum())} pixels, expected {expect}")
    check(launches == FRAMES, f"upsampled_argmax launched {launches} times for {FRAMES} frames")
    check(counts["K6"] == 0, f"the unfused student launched K6 {counts['K6']} times")
    stats = {"miou": miou, "ms_per_frame": 1e3 * took / FRAMES, "launches": launches,
             "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    phase(4, "slice", model="student R18 full width f32", frames=FRAMES, **stats)
    return stats


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


def _ce_case(device, heads, dtype, ignored, seed):
    g = torch.Generator().manual_seed(seed)
    xs = [(2.0 * torch.randn(TRAIN_SHAPE, generator=g)).to(device, dtype).requires_grad_()
          for _ in range(heads)]
    # int32, as the train step's labels are (data/synthetic.py): the wrapper
    # then launches no cast of its own inside the timed forward
    labels = torch.randint(0, NUM_CLASSES, (TRAIN_SHAPE[0],) + TRAIN_CROP, generator=g,
                           dtype=torch.int32)
    labels[torch.rand(labels.shape, generator=g) < ignored] = 255
    return xs, labels.to(device)


def phase_ce_kernel(device: torch.device) -> dict:
    """K2–K5 against the plain versions; returns the JSON fields per kernel."""
    # the forward, and pass 1 and pass 2 of the backward, one instantiation
    # per dtype each
    ce_ptxas = [k for k in ptxas_report() if "ce_fwd" in k["function"] or
                "ce_bwd" in k["function"]]
    check(len(ce_ptxas) == 6 and
          all(k["spill_stores"] == k["spill_loads"] == 0 for k in ce_ptxas),
          f"the CE kernels' ptxas report: {ce_ptxas}")
    cases, record = [], {}
    for heads, fn, plain, k_fwd, k_bwd in ((2, upsampled_ce_loss_dsn, upsampled_ce_loss_dsn_plain,
                                            "K4", "K5"),
                                           (1, upsampled_ce_loss, upsampled_ce_loss_plain,
                                            "K2", "K3")):
        for dtype in (torch.float32, torch.bfloat16):
            for ignored in (0.05, 1.0):
                xs, labels = _ce_case(device, heads, dtype, ignored, 7 + heads)
                runs = []
                for _ in range(2):
                    loss = fn(*xs, labels, TRAIN_CROP)
                    runs.append((loss.detach(), torch.autograd.grad(loss, xs)))
                ref = plain(*xs, labels, TRAIN_CROP)
                ref_grads = torch.autograd.grad(ref, xs)
                torch.cuda.synchronize()
                (loss, grads), (loss2, grads2) = runs
                name = f"{heads}-head {str(dtype)[6:]} ignored={ignored}"
                check(torch.equal(loss, loss2) and all(torch.equal(a, b)
                                                       for a, b in zip(grads, grads2)),
                      f"{name}: two runs differ")
                loss_err = abs(loss.item() - ref.item())
                check(loss_err <= CE_LOSS_RTOL * abs(ref.item()) + 1e-7,
                      f"{name}: loss {loss.item()} vs plain {ref.item()}")
                grad_err = max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(grads, ref_grads))
                grad_max = max(b.float().abs().max().item() for b in ref_grads)
                check(grad_err <= CE_GRAD_REL[dtype] * grad_max + 1e-12,
                      f"{name}: grad max |diff| {grad_err} vs max |grad| {grad_max}")
                check(all(gr.dtype == dtype for gr in grads), f"{name}: grad dtype")
                if ignored == 1.0:
                    check(loss.item() == 0.0 and not any(gr.any() for gr in grads),
                          f"{name}: an all-ignored batch gives a non-zero loss or gradient")
                    cases.append({"case": name, "loss": loss.item(), "bit_identical": True})
                    continue
                fwd_ms = cuda_median_ms(lambda: fn(*xs, labels, TRAIN_CROP))
                plain_fwd_ms = cuda_median_ms(lambda: plain(*xs, labels, TRAIN_CROP))
                fb_ms = cuda_median_ms(
                    lambda: torch.autograd.grad(fn(*xs, labels, TRAIN_CROP), xs))
                plain_fb_ms = cuda_median_ms(
                    lambda: torch.autograd.grad(plain(*xs, labels, TRAIN_CROP), xs))
                loss = fn(*xs, labels, TRAIN_CROP)
                ref = plain(*xs, labels, TRAIN_CROP)
                bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(loss, xs, retain_graph=True))
                plain_bwd_ms = cuda_median_ms(
                    lambda: torch.autograd.grad(ref, xs, retain_graph=True))
                if heads == 2 and dtype == torch.bfloat16:
                    check(plain_fwd_ms >= CE_FWD_SPEEDUP_MIN * fwd_ms,
                          f"K4 {name}: {fwd_ms} ms is not {CE_FWD_SPEEDUP_MIN}x faster than "
                          f"the plain version's {plain_fwd_ms} ms")
                    check(plain_bwd_ms >= CE_BWD_SPEEDUP_MIN * bwd_ms,
                          f"K5 {name}: {bwd_ms} ms is not {CE_BWD_SPEEDUP_MIN}x faster than "
                          f"the plain version's {plain_bwd_ms} ms")
                cases.append({"case": name, "loss": loss.item(), "loss_abs_err": loss_err,
                              "grad_max_abs_err": grad_err, "grad_max": grad_max,
                              "bit_identical": True, "fwd_ms": fwd_ms,
                              "plain_fwd_ms": plain_fwd_ms,
                              "fwd_speedup_vs_plain": plain_fwd_ms / fwd_ms, "bwd_ms": bwd_ms,
                              "plain_bwd_ms": plain_bwd_ms,
                              "bwd_speedup_vs_plain": plain_bwd_ms / bwd_ms, "fwd_bwd_ms": fb_ms,
                              "plain_fwd_bwd_ms": plain_fb_ms})
                if dtype == torch.bfloat16:  # the train step's logits are bf16
                    # per head: the separable resize of every class (3 per
                    # sample, along H, then along W); per labelled pixel and
                    # class, the log-softmax's max, exp and sum (3); the
                    # backward adds softmax − one-hot (2) and the transposed
                    # resize of the gradient. No one PyTorch call upsamples
                    # and takes the CE (library_ms null).
                    n, c, h_in, w_in = TRAIN_SHAPE
                    h_out, w_out = TRAIN_CROP
                    valid = int((labels != 255).sum())
                    resize = 3 * n * c * h_out * (w_in + w_out)
                    fwd_flops = heads * (resize + 3 * c * valid)
                    bwd_flops = heads * (2 * resize + 5 * c * valid)
                    logits_bytes = sum(t.nbytes for t in xs)
                    label_bytes = labels.numel() * 4  # the kernels read int32 labels
                    record[k_fwd] = {"max_abs_err": loss_err, "ms": fwd_ms,
                                     "plain_ms": plain_fwd_ms, "library_ms": None,
                                     **card_bound(logits_bytes + label_bytes + 4, fwd_flops)}
                    record[k_bwd] = {"max_abs_err": grad_err, "ms": bwd_ms,
                                     "plain_ms": plain_bwd_ms, "library_ms": None,
                                     **card_bound(2 * logits_bytes + label_bytes, bwd_flops)}
                    for k in (k_fwd, k_bwd):
                        record[k]["bound_share"] = record[k]["bound_ms"] / record[k]["ms"]
    phase(7, "ce_kernel", shape=list(TRAIN_SHAPE), out=list(TRAIN_CROP), cases=cases,
          ptxas=ce_ptxas)
    return record


def _train_config(**overrides) -> TrainConfig:
    kwargs = dict(data_set="synthetic", classes_num=NUM_CLASSES, batch_size=8,
                  input_size=TRAIN_CROP, compute_dtype="bfloat16", pi=True, pa=True, ho=True,
                  adv_loss_type="wgan-gp", device="cuda", log_every=1)
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def _flat_params(module: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float() for p in module.parameters()])


def _train_batches(cfg) -> list:
    ds = SyntheticSegDataset((WARMUP_STEPS + TIMED_STEPS) * cfg.batch_size, TRAIN_CROP,
                             NUM_CLASSES, seed=0)
    return list(batch_iterator(ds, cfg.batch_size, shuffle=False))


def _check_steps(steps: list, s_before, d_before, student, disc) -> None:
    check(len(steps) == WARMUP_STEPS + TIMED_STEPS, f"{len(steps)} logged steps")
    for m in steps:
        check(all(math.isfinite(v) for v in m.values()), f"a loss is not finite: {m}")
    check(not torch.equal(s_before, _flat_params(student)), "student unchanged")
    check(not torch.equal(d_before, _flat_params(disc)), "D unchanged")


def phase_train(device: torch.device) -> dict:
    cfg = _train_config()
    teacher = teacher_model(NUM_CLASSES, generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(teacher, 3)
    trainer = KDTrainer(cfg, teacher_state=teacher.state_dict())
    del teacher
    batches = _train_batches(cfg)
    s_before, d_before = _flat_params(trainer.student), _flat_params(trainer.discriminator)

    trainer.fit(batches[:WARMUP_STEPS])
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(batches[WARMUP_STEPS:])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = read_counts()

    steps = [m for _, m in trainer.history]
    _check_steps(steps, s_before, d_before, trainer.student, trainer.discriminator)
    check(launches["K4"] == TIMED_STEPS and launches["K5"] == TIMED_STEPS,
          f"K4/K5 launched {launches['K4']}/{launches['K5']} times in {TIMED_STEPS} steps")
    check(launches["K6"] == 0, f"the unfused step launched K6 {launches['K6']} times")
    stats = {"ms_per_step": 1e3 * took / TIMED_STEPS,
             "images_per_second": cfg.batch_size * TIMED_STEPS / took,
             "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    phase(8, "train", model="R101 teacher -> R18 student, full width, bf16 convs",
          batch=cfg.batch_size, crop=list(TRAIN_CROP), steps=TIMED_STEPS, **stats,
          launches={k: launches[k] for k in ("K2", "K3", "K4", "K5")},
          first_step=steps[0], last_step=steps[-1])
    return {"launches": launches, **stats}


def _fused_abns(*models) -> int:
    return sum(isinstance(m, ABN) and m.fused for model in models for m in model.modules())


def phase_train_fused(device: torch.device, unfused: dict) -> dict:
    """Phase 8's models and batches with bn_fused=True teacher and student:
    the R101 teacher from the same seed and running statistics, student and
    D drawn from the trainer's generator as `KDTrainer` draws them, the steps
    through `make_train_step` and fed as `KDTrainer.fit` feeds them."""
    cfg = _train_config()
    dtype = torch.bfloat16
    teacher = ResPSPNet(BOTTLENECK, tuple(cfg.teacher_layers), NUM_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(2), dtype=dtype, bn_fused=True)
    randomize_bn_stats(teacher, 3)
    teacher.requires_grad_(False)
    gen = torch.Generator().manual_seed(cfg.seed)
    student = ResPSPNet(BASIC, (2, 2, 2, 2), NUM_CLASSES, device=device, dtype=dtype,
                        generator=gen, bn_fused=True)
    disc = Discriminator(NUM_CLASSES, preprocess_mode=cfg.preprocess_gan_mode,
                         image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim, dtype=dtype,
                         device=device, generator=gen)
    state = KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    train_step = make_train_step(cfg)
    n_teacher, n_student = _fused_abns(teacher), _fused_abns(student)
    batches = _train_batches(cfg)
    s_before, d_before = _flat_params(student), _flat_params(disc)
    steps = []

    def fit(part):
        for batch in part:
            images = torch.from_numpy(np.ascontiguousarray(batch[0])).to(device)
            images = images.permute(0, 3, 1, 2).contiguous()
            labels = torch.from_numpy(np.asarray(batch[1])).to(device)
            metrics = train_step(state, images, labels, gen)
            steps.append({k: float(v) for k, v in metrics.items()})  # log every step, as phase 8

    fit(batches[:WARMUP_STEPS])
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    fit(batches[WARMUP_STEPS:])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = read_counts()

    _check_steps(steps, s_before, d_before, student, disc)
    expect = {"K6": (n_teacher + n_student) * TIMED_STEPS, "K7": n_student * TIMED_STEPS,
              "K8": n_student * TIMED_STEPS, "K4": TIMED_STEPS, "K5": TIMED_STEPS}
    for k, n in expect.items():
        check(launches[k] == n, f"{k} launched {launches[k]} times in {TIMED_STEPS} steps, "
                                f"expected {n}")
    # one more step, after the timed ones, with every K6–K8 call recorded
    per_step = _bn_launch_sums(_record_bn_launches(lambda: fit(batches[:1])), device)
    for k in ("K6", "K7", "K8"):
        check(per_step[k]["launches"] * TIMED_STEPS == expect[k],
              f"the recorded step launched {k} {per_step[k]['launches']} times")
    stats = {"ms_per_step": 1e3 * took / TIMED_STEPS,
             "images_per_second": cfg.batch_size * TIMED_STEPS / took,
             "max_memory_allocated": torch.cuda.max_memory_allocated(device)}
    phase(11, "train_fused", model="R101 teacher -> R18 student, bn_fused, full width, bf16 convs",
          batch=cfg.batch_size, crop=list(TRAIN_CROP), steps=TIMED_STEPS,
          abn_modules={"teacher": n_teacher, "student": n_student}, **stats,
          unfused={k: unfused[k] for k in stats},
          launches={k: launches[k] for k in expect}, first_step=steps[0], last_step=steps[-1],
          bn_per_step=per_step)
    return {"launches": launches}


def _small_state(device, sd=None, bn_fused: bool = False) -> KDTrainState:
    cfg = _small_config(device)
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0,
                        generator=g, bn_fused=bn_fused)
    student = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, generator=g,
                        bn_fused=bn_fused)
    disc = Discriminator(7, 1, 33, 16, generator=g)
    if sd is not None:
        for model, state in zip((teacher, student, disc), sd):
            model.load_state_dict(state)
    else:
        for model in (teacher, student, disc):
            randomize_affine(model, 12)
    teacher.to(device).requires_grad_(False)
    student.to(device)
    disc.to(device)
    return KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def _small_config(device) -> TrainConfig:
    return TrainConfig(classes_num=7, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                       adv_conv_dim=16, num_steps=4, compute_dtype="float32",
                       device=str(device))


def phase_train_gpu_vs_cpu(device: torch.device, bn_fused: bool = False) -> None:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = _small_state("cpu", bn_fused=bn_fused)
        start = [{k: v.clone() for k, v in m.state_dict().items()}
                 for m in (cpu.teacher, cpu.student, cpu.discriminator)]
        gpu = _small_state(device, start, bn_fused)
        rng = np.random.RandomState(5)
        images = rng.randn(2, 3, 256, 256).astype(np.float32)
        images[1] = 3.0 * images[1] + 1.0  # two images of different statistics
        labels = rng.randint(0, 7, (2, 256, 256))
        labels[0, :16] = 255
        alpha = torch.from_numpy(rng.rand(2, 1, 1, 1).astype(np.float32))
        zero_counts()
        m_gpu = make_train_step(_small_config(device))(
            gpu, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device),
            alpha=alpha.to(device))
        counts = read_counts()
        check(counts["K4"] == 1, "the GPU step did not launch K4")
        if bn_fused:
            n_teacher, n_student = _fused_abns(gpu.teacher), _fused_abns(gpu.student)
            check((counts["K6"], counts["K7"], counts["K8"]) ==
                  (n_teacher + n_student, n_student, n_student),
                  f"the fused GPU step launched K6/K7/K8 {counts['K6']}/{counts['K7']}/"
                  f"{counts['K8']} times")
        m_cpu = make_train_step(_small_config("cpu"))(
            cpu, torch.from_numpy(images), torch.from_numpy(labels), alpha=alpha)
        loss_rel = {}
        for k, v in m_cpu.items():
            a, b = float(m_gpu[k]), float(v)
            check(math.isfinite(a) and abs(a - b) <= STEP_LOSS_RTOL * abs(b) + STEP_LOSS_ATOL,
                  f"GPU vs CPU {k}: {a} vs {b}")
            loss_rel[k] = abs(a - b) / max(abs(b), 1e-30)
        worst = (0.0, "")
        for name, start_sd, g_mod, c_mod in (("student", start[1], gpu.student, cpu.student),
                                             ("disc", start[2], gpu.discriminator,
                                              cpu.discriminator)):
            g_sd, c_sd = g_mod.state_dict(), c_mod.state_dict()
            updates = {k: ((g_sd[k].cpu() - start_sd[k]).double(),
                           (c_sd[k] - start_sd[k]).double())
                       for k, _ in c_mod.named_parameters()}
            # a tensor whose update is under 1e-4 of the model's largest (a
            # conv bias before a train-mode BN has an analytically zero
            # gradient and moves by weight decay alone) is held to that floor
            floor = UPDATE_FLOOR * max(dt.norm().item() for _, dt in updates.values())
            for k, (dg, dt) in updates.items():
                nt, err = dt.norm().item(), (dg - dt).norm().item()
                check(err <= max(STEP_UPDATE_REL_L2 * nt, floor),
                      f"GPU vs CPU update of {name}.{k}: |diff| {err} vs |update| {nt}")
                if nt > floor:
                    cos = (dg * dt).sum().item() / (dg.norm().item() * nt + 1e-30)
                    check(cos > STEP_UPDATE_COS, f"GPU vs CPU update of {name}.{k}: cos {cos}")
                    worst = max(worst, (err / nt, f"{name}.{k}"))
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = flags
    phase(12 if bn_fused else 9, "train_fused_gpu_vs_cpu" if bn_fused else "train_gpu_vs_cpu",
          loss_rel_diff=loss_rel, worst_update_rel_l2=worst[0],
          worst_update_tensor=worst[1], loss_rtol=STEP_LOSS_RTOL,
          update_rel_l2_max=STEP_UPDATE_REL_L2, update_cos_min=STEP_UPDATE_COS,
          update_floor=UPDATE_FLOOR)


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bn_case(device, shape, dtype, activation, seed):
    """x and an incoming gradient (non-zero mean) made on the card; the ABN
    parameters (signed weights) and random running statistics; the train-
    and eval-mode scale and shift; the saved output z of the train forward
    (an ELU's kept above −1)."""
    g = torch.Generator(device=device).manual_seed(seed)
    c = shape[1]
    x = (2.0 * torch.randn(shape, generator=g, device=device) + 0.3).to(dtype)
    dz = (torch.randn(shape, generator=g, device=device) + 0.5).to(dtype)
    w = (torch.where(torch.rand(c, generator=g, device=device) < 0.25, -1.0, 1.0)
         * (0.5 + torch.rand(c, generator=g, device=device)))
    b = 0.3 * torch.randn(c, generator=g, device=device)
    r_mean = 0.1 * torch.randn(c, generator=g, device=device)
    r_var = 0.5 + torch.rand(c, generator=g, device=device)
    mean, var, _ = _moments(x.float())
    gamma, tr_scale, tr_shift = fused_bn._scale_shift(mean, var, w, b, BN_EPS, True)
    _, ev_scale, ev_shift = fused_bn._scale_shift(r_mean, r_var, w, b, BN_EPS, True)
    z = bn_act_plain(x, tr_scale, tr_shift, activation)
    if activation == "elu":
        # below a pre-activation of about −5.5 a bf16 ELU output rounds to −1,
        # which has no inverse (log1p(−1) = −inf, in the JAX package as here)
        z = z.clamp_min(-0.95)
    coef = gamma * torch.rsqrt(var + BN_EPS)
    edz, eydz = (0.1 * torch.randn(c, generator=g, device=device) for _ in range(2))
    return dict(x=x, dz=dz, w=w, b=b, r_mean=r_mean, r_var=r_var, gamma=gamma,
                scale={"train": tr_scale, "eval": ev_scale},
                shift={"train": tr_shift, "eval": ev_shift}, z=z, coef=coef, edz=edz, eydz=eydz)


def _twice(fn, name: str):
    """Two launches of `fn`; both must be bit-identical. Returns the first."""
    a, b = fn(), fn()
    for u, v in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
        same = (u == v) | (torch.isnan(u) & torch.isnan(v))
        check(bool(same.all()), f"{name}: two runs differ in {int((~same).sum())} of "
                                f"{u.numel()} values (NaN: {int(torch.isnan(u).sum())})")
    return a


def phase_bn_kernel(device: torch.device) -> dict:
    """K6–K8 against their plain versions; returns the JSON fields per kernel:
    K6 at the R101 layer4 eval shape, K7 and K8 at the stem, bf16, no
    activation (the path's largest calls of each)."""
    cases, record = [], {}
    for where, shape in BN_SHAPES.items():
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("none", "leaky_relu", "elu"):
                t = _bn_case(device, shape, dtype, act, len(cases))
                name = f"{where} {tuple(shape)} {str(dtype)[6:]} {act}"
                errs = {}
                for mode in ("train", "eval"):
                    sc, sh = t["scale"][mode], t["shift"][mode]
                    z = _twice(lambda: bn_act(t["x"], sc, sh, act), f"K6 {name} {mode}")
                    ref = bn_act_plain(t["x"], sc, sh, act)
                    diff = (z.float() - ref.float()).abs()
                    bound = (BN_FWD_RTOL * ref.float().abs() if dtype == torch.float32
                             else _bf16_ulp(ref))
                    check(z.dtype == dtype and bool((diff <= bound).all()),
                          f"K6 {name} {mode}: max |diff| {diff.max().item()}")
                    errs[f"K6 {mode}"] = diff.max().item()
                prm = (t["z"], t["dz"], t["gamma"], t["b"])
                sums = _twice(lambda: bn_grad_sums(*prm, act), f"K7 {name}")
                for s, r in zip(sums, bn_grad_sums_plain(*prm, act)):
                    err = (s - r).abs().max().item()
                    check(err <= BN_SUM_REL * r.abs().max().item(),
                          f"K7 {name}: max |diff| {err} vs max |sum| {r.abs().max().item()}")
                    errs["K7"] = max(errs.get("K7", 0.0), err)
                bwd = (*prm, t["coef"], t["edz"], t["eydz"], act, 0.01)
                for training in (True, False):
                    dx = _twice(lambda: bn_grad_input(*bwd, training),
                                f"K8 {name} training={training}")
                    ref = bn_grad_input_plain(*bwd, training)
                    err = (dx.float() - ref.float()).abs().max().item()
                    check(dx.dtype == dtype and
                          err <= BN_DX_REL[dtype] * ref.float().abs().max().item(),
                          f"K8 {name} training={training}: max |diff| {err}")
                    errs[f"K8 training={training}"] = err
                sc, sh = t["scale"]["eval"], t["shift"]["eval"]
                ms = {"K6": cuda_median_ms(lambda: bn_act(t["x"], sc, sh, act)),
                      "K6 plain": cuda_median_ms(lambda: bn_act_plain(t["x"], sc, sh, act)),
                      "K7": cuda_median_ms(lambda: bn_grad_sums(*prm, act)),
                      "K7 plain": cuda_median_ms(lambda: bn_grad_sums_plain(*prm, act)),
                      "K8": cuda_median_ms(lambda: bn_grad_input(*bwd, True)),
                      "K8 plain": cuda_median_ms(lambda: bn_grad_input_plain(*bwd, True))}
                case = {"case": name, "max_abs_err": errs, "bit_identical": True, "ms": ms}
                if dtype == torch.bfloat16 and act == "none":
                    case["unfused_ms"] = _unfused_abn_ms(t, where)
                    numel, c = t["x"].numel(), shape[1]
                    if where == "R101 layer4 eval":
                        # x·scale + shift: one FMA per element. One PyTorch
                        # call computes it: an eval-mode F.batch_norm with
                        # mean 0, var 1 − eps, weight scale and bias shift
                        zero = torch.zeros_like(sc)
                        library_ms = cuda_median_ms(lambda: F.batch_norm(
                            t["x"], zero, 1.0 - BN_EPS + zero, sc, sh, False, 0.0, BN_EPS))
                        record["K6"] = {"max_abs_err": errs["K6 eval"], "ms": ms["K6"],
                                        "plain_ms": ms["K6 plain"], "library_ms": library_ms,
                                        **card_bound(2 * t["x"].nbytes + 8 * c, 2 * numel)}
                    if where == "stem":
                        # K7: ŷ from z (2), dz·ŷ (1), two sums (2) per element;
                        # K8: ŷ (2) and dx from dz, ŷ and four per-channel
                        # values (6). Torch's batch-norm backward takes x and
                        # the batch statistics, not the saved output z: no
                        # one PyTorch call computes either (library_ms null).
                        zd = t["z"].nbytes + t["dz"].nbytes
                        record["K7"] = {"max_abs_err": errs["K7"], "ms": ms["K7"],
                                        "plain_ms": ms["K7 plain"], "library_ms": None,
                                        **card_bound(zd + 16 * c, 5 * numel)}
                        record["K8"] = {"max_abs_err": errs["K8 training=True"],
                                        "ms": ms["K8"], "plain_ms": ms["K8 plain"],
                                        "library_ms": None,
                                        **card_bound(zd + t["dz"].nbytes + 20 * c, 8 * numel)}
                cases.append(case)
                del t
    phase(10, "bn_kernel", cases=cases)
    return record


def _record_bn_launches(run) -> list:
    """Calls `run()` with fused_bn's K6–K8 wrappers replaced by recorders that
    note each call's (kernel, shape, dtype, activation, training) and pass it
    on; the ABN functions look the wrappers up in fused_bn when they call
    them. The package is not changed: the originals are put back."""
    names = {"bn_act": "K6", "bn_grad_sums": "K7", "bn_grad_input": "K8"}
    originals = {name: getattr(fused_bn, name) for name in names}
    log = []

    def recorder(name):
        fn, sig = originals[name], inspect.signature(originals[name])

        def record(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            t = a.arguments.get("x", a.arguments.get("z"))
            log.append((names[name], tuple(t.shape), t.dtype, a.arguments["activation"],
                        a.arguments.get("training", True)))
            return fn(*args, **kwargs)
        # a wrapper counts its launches through its module-level name, the
        # recorder while it stands there
        record.launches = fn.launches
        return record

    try:
        for name in names:
            setattr(fused_bn, name, recorder(name))
        run()
        torch.cuda.synchronize()
    finally:
        for name, fn in originals.items():
            fn.launches = getattr(fused_bn, name).launches
            setattr(fused_bn, name, fn)
    return log


def _bn_launch_sums(log: list, device: torch.device) -> dict:
    """Per kernel of K6–K8 over the launches of `log` (one step or frame):
    Σ launches × ms and Σ launches × bound_ms, each distinct (shape, dtype,
    activation, training) timed once with cuda_median_ms on inputs from
    _bn_case and bounded by phase 10's `card_bound` counts; the share of the
    bound reached, and the call with the largest launches × (ms − bound)."""
    sums = {}
    for (kernel, shape, dtype, act, training), n in sorted(Counter(log).items(), key=str):
        t = _bn_case(device, shape, dtype, act, 0)
        numel, c = math.prod(shape), shape[1]
        if kernel == "K6":
            sc, sh = t["scale"]["train"], t["shift"]["train"]
            ms = cuda_median_ms(lambda: bn_act(t["x"], sc, sh, act))
            bound = card_bound(2 * t["x"].nbytes + 8 * c, 2 * numel)["bound_ms"]
        elif kernel == "K7":
            prm = (t["z"], t["dz"], t["gamma"], t["b"])
            ms = cuda_median_ms(lambda: bn_grad_sums(*prm, act))
            bound = card_bound(t["z"].nbytes + t["dz"].nbytes + 16 * c, 5 * numel)["bound_ms"]
        else:
            bwd = (t["z"], t["dz"], t["gamma"], t["b"], t["coef"], t["edz"], t["eydz"], act, 0.01)
            ms = cuda_median_ms(lambda: bn_grad_input(*bwd, training))
            bound = card_bound(t["z"].nbytes + 2 * t["dz"].nbytes + 20 * c,
                               8 * numel)["bound_ms"]
        del t
        k = sums.setdefault(kernel, {"launches": 0, "shapes": 0, "ms": 0.0, "bound_ms": 0.0,
                                     "worst": None})
        k["launches"] += n
        k["shapes"] += 1
        k["ms"] += n * ms
        k["bound_ms"] += n * bound
        loss = n * (ms - bound)
        if k["worst"] is None or loss > k["worst"]["lost_ms"]:
            k["worst"] = {"shape": list(shape), "dtype": str(dtype)[6:], "activation": act,
                          "launches": n, "ms": ms, "bound_ms": bound, "lost_ms": loss}
    for k in sums.values():
        k["bound_share"] = k["bound_ms"] / k["ms"]
    return sums


def _unfused_abn_ms(t: dict, where: str) -> dict:
    """The whole ABN, fused against the port's unfused one, on the same
    tensors: the eval normalisation (abn_fused_eval vs abn_normalize) and the
    train forward + backward (abn_fused_train vs abn_train)."""
    x, w, b = t["x"], t["w"], t["b"]
    with torch.no_grad():
        out = {"eval_fused": cuda_median_ms(lambda: abn_fused_eval(
                   x, w, b, t["r_mean"], t["r_var"], BN_EPS, "none")),
               "eval_unfused": cuda_median_ms(lambda: abn_normalize(
                   x, t["r_mean"], t["r_var"], w, b, eps=BN_EPS))}
    if where == "R101 layer4 eval":  # the teacher is never trained
        return out
    xg, wg, bg = (t.detach().requires_grad_() for t in (x, w, b))

    def fwd_bwd(fn):
        z = fn(xg, wg, bg, BN_EPS, "none")[0]
        return torch.autograd.grad(z, (xg, wg, bg), t["dz"])

    out["train_fwd_bwd_fused"] = cuda_median_ms(lambda: fwd_bwd(abn_fused_train), reps=10)
    out["train_fwd_bwd_unfused"] = cuda_median_ms(lambda: fwd_bwd(abn_train), reps=10)
    return out


def phase_eval_fused(device: torch.device, unfused: dict) -> dict:
    plain = _eval_student(device)
    model = ResPSPNet(BASIC, (2, 2, 2, 2), NUM_CLASSES, device=device, bn_fused=True)
    model.load_state_dict(plain.state_dict())
    model.eval()
    n_abn = _fused_abns(model)
    frames = _eval_frames()
    miou, conf, took, launches = _timed_eval(model, frames, device)
    peak = torch.cuda.max_memory_allocated(device)
    miou_plain, _, _ = evaluate_main(plain, frames, NUM_CLASSES, out_size=FULL_RES, device=device)

    fused_fn = make_fast_val_fn(model, FULL_RES, NUM_CLASSES)
    plain_fn = make_fast_val_fn(plain, FULL_RES, NUM_CLASSES)
    same = total = 0
    with torch.no_grad():
        for image, label, size, _ in frames:
            x = torch.from_numpy(np.ascontiguousarray(image)).to(device)
            x = x.permute(0, 3, 1, 2).contiguous()
            lab = torch.from_numpy(np.asarray(label[0]).astype(np.uint8)).to(device)
            h, w = int(size[0][0]), int(size[0][1])
            pred = fused_fn(x, lab, h, w)[0]
            same += int((pred == plain_fn(x, lab, h, w)[0]).sum())
            total += pred.numel()
    agree = same / total
    image, label, size, _ = frames[0]
    x = torch.from_numpy(np.ascontiguousarray(image)).to(device).permute(0, 3, 1, 2).contiguous()
    lab = torch.from_numpy(np.asarray(label[0]).astype(np.uint8)).to(device)
    with torch.no_grad():
        per_frame = _bn_launch_sums(_record_bn_launches(
            lambda: fused_fn(x, lab, int(size[0][0]), int(size[0][1]))), device)

    check(math.isfinite(miou) and 0.0 <= miou <= 1.0, f"fused student mIoU {miou}")
    check(per_frame["K6"]["launches"] == n_abn and set(per_frame) == {"K6"},
          f"the recorded frame launched {({k: v['launches'] for k, v in per_frame.items()})}")
    check(int(conf.sum()) == sum(int((b[1] != 255).sum()) for b in frames),
          "fused student confusion count is off")
    check(launches["K6"] == n_abn * FRAMES,
          f"K6 launched {launches['K6']} times for {n_abn} ABNs × {FRAMES} frames")
    check(launches["K1"] == FRAMES, f"K1 launched {launches['K1']} times for {FRAMES} frames")
    check(abs(miou - miou_plain) <= EVAL_MIOU_ATOL, f"fused mIoU {miou} vs unfused {miou_plain}")
    check(agree >= CLASS_MAP_AGREEMENT_MIN, f"fused vs unfused class maps agree in {agree}")
    phase(13, "eval_fused", model="student R18 bn_fused full width f32", frames=FRAMES,
          abn_modules=n_abn, miou=miou, miou_unfused=miou_plain, class_map_agreement=agree,
          ms_per_frame=1e3 * took / FRAMES, unfused_ms_per_frame=unfused["ms_per_frame"],
          launches={"K1": launches["K1"], "K6": launches["K6"]}, max_memory_allocated=peak,
          unfused_max_memory_allocated=unfused["max_memory_allocated"], bn_per_frame=per_frame)
    return {"launches": launches}


def _conv_bound(x: torch.Tensor, w: torch.Tensor) -> dict:
    """K9's bound: 2·9·Cin·Cout operations per output pixel on the tensor
    cores (bf16) or the CUDA cores (f32, TF32 off); x and w read once, the
    output written once in x's dtype."""
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    flops = 2 * 9 * n * h * wd * cin * cout
    nbytes = x.nbytes + w.nbytes + n * h * wd * cout * x.element_size()
    return card_bound(nbytes, flops, "bf16 tensor" if x.dtype == torch.bfloat16 else "f32")


def _direct_conv_ms(x: torch.Tensor, w: torch.Tensor) -> tuple:
    """The direct kernel (csrc/conv3x3.cu) at a shape that the wrapper routes
    to the wgmma kernel, through its C entry point (so no count moves):
    (device ms, its output)."""
    lib = _build.load_kernels()
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream

    def run():
        err = lib.skd_conv3x3(x.data_ptr(), w.data_ptr(), out.data_ptr(), 1, n, h, wd, cin, cout,
                              stream)
        check(err == 0, f"direct conv3x3 kernel launch failed: cudaError {err}")

    return cuda_median_ms(run, reps=3, trials=3), out


def phase_conv3x3_probe(device: torch.device) -> dict:
    """The JAX probe's main on the card: K9 against cuDNN at the stem-like
    conv, (8,256,256,64) bf16 → Cout 64 and 128 (the wgmma kernel), the f32
    case and a ragged bf16 case (the direct kernel). Returns the JSON fields
    of the two kernels."""
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(CONV_SHAPE, generator=g, device=device).to(torch.bfloat16)
    runs = []
    for cout in CONV_COUTS:
        w = (0.1 * torch.randn((3, 3, CONV_SHAPE[3], cout), generator=g, device=device))
        runs.append(("wgmma", x, w.to(torch.bfloat16)))
    runs.append(("direct", x.float(), runs[0][2].float()))
    shape, cout = CONV_RAGGED
    runs.append(("direct", torch.randn(shape, generator=g, device=device).to(torch.bfloat16),
                 (0.1 * torch.randn((3, 3, shape[3], cout), generator=g, device=device))
                 .to(torch.bfloat16)))
    zero_counts()
    outs = [conv3x3(xi, wi) for _, xi, wi in runs]
    torch.cuda.synchronize()
    launches = read_counts()
    check(launches["K9"] == len(runs) and launches["K9-wgmma"] == len(CONV_COUTS),
          f"the probe launched K9 {launches['K9']} times, {launches['K9-wgmma']} of them "
          f"the wgmma kernel")
    # one instantiation per Cout and weight placement (resident or streamed)
    spills = [k for k in ptxas_report() if "conv3x3_wgmma" in k["function"]]
    check(len(spills) == 2 * len(CONV_COUTS) and
          all(k["spill_stores"] == k["spill_loads"] == 0 for k in spills),
          f"the wgmma kernel's ptxas report: {spills}")

    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        cases, record = [], {}
        for (want, xi, wi), out in zip(runs, outs):
            dtype, cout = xi.dtype, wi.shape[3]
            route = _route(dtype, xi.shape[3], cout)
            name = f"{tuple(xi.shape)}->{cout} {str(dtype)[6:]}"
            check(route == want, f"K9 {name} took the {route} route, not {want}")
            ref = conv3x3_plain(xi, wi)
            err = (out.float() - ref.float()).abs().max().item()
            scale = ref.float().abs().max().item()
            check(out.dtype == dtype and out.shape == ref.shape, f"K9 {name}: dtype or shape")
            check(err <= CONV_REL[dtype] * scale, f"K9 {name}: max |diff| {err} vs max {scale}")
            check(torch.equal(out, conv3x3(xi, wi)), f"K9 {name}: two runs differ")
            xv, wv = xi.permute(0, 3, 1, 2), wi.permute(3, 2, 0, 1)
            ms = cuda_median_ms(lambda: conv3x3(xi, wi), reps=5, trials=3)
            case = {"case": name, "route": route, "rel_err": err / scale,
                    "rel_tol": CONV_REL[dtype], "max_abs_err": err, "ms": ms,
                    "plain_ms": cuda_median_ms(lambda: conv3x3_plain(xi, wi), reps=5, trials=3),
                    "library_ms": cuda_median_ms(lambda: F.conv2d(xv, wv, padding=1),
                                                 reps=5, trials=3),
                    **_conv_bound(xi, wi)}
            case["bound_share"] = case["bound_ms"] / ms
            if route == "wgmma":
                direct_ms, direct_out = _direct_conv_ms(xi, wi)
                direct_err = (direct_out.float() - ref.float()).abs().max().item()
                check(direct_err <= CONV_REL[dtype] * scale,
                      f"K9 {name} direct kernel: max |diff| {direct_err} vs max {scale}")
                case.update(direct_ms=direct_ms, speedup_vs_direct=direct_ms / ms)
                check(direct_ms >= CONV_SPEEDUP_MIN * ms,
                      f"K9 {name}: wgmma {ms} ms is not {CONV_SPEEDUP_MIN}x faster than the "
                      f"direct kernel's {direct_ms} ms")
            cases.append(case)
            # the JSON entry of each kernel: the first probe-shape case it ran
            if route not in record:
                record[route] = {k: case[k] for k in ("max_abs_err", "ms", "plain_ms",
                                                      "library_ms", "bound_ms", "bound_by")}
                record[route]["case"] = name
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    record["wgmma"]["launches"] = launches["K9-wgmma"]
    record["direct"]["launches"] = launches["K9"] - launches["K9-wgmma"]
    record["direct"]["bf16_probe_ms"] = cases[0]["direct_ms"]
    phase(14, "conv3x3_probe", cases=cases,
          launches={"K9": launches["K9"], "K9-wgmma": launches["K9-wgmma"]}, ptxas=spills)
    return record


def main() -> int:
    phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    k1 = phase_kernel(device)
    eval_stats = phase_slice(device)
    phase_gpu_vs_cpu(device)
    phase_teacher(device)
    ce = phase_ce_kernel(device)
    train = phase_train(device)
    phase_train_gpu_vs_cpu(device)
    bn = phase_bn_kernel(device)
    train_fused = phase_train_fused(device, train)
    phase_train_gpu_vs_cpu(device, bn_fused=True)
    eval_fused = phase_eval_fused(device, eval_stats)
    k9 = phase_conv3x3_probe(device)
    kernels = [{
        "name": "upsampled_argmax",
        "route": "cuda",
        "source": "structure_knowledge_distillation_tpu_torch/csrc/upsampled_argmax.cu",
        "replaces": "structure_knowledge_distillation_tpu/ops/pallas_eval.py:87",
        "path": "eval",
        "launches": eval_stats["launches"],
        "design": ("upsampled_argmax_kernel: a block per (image, low-res row interval, window of "
                   "512 columns) stages the two low-res rows, interpolates along H once per row "
                   "into class-minor pairs and along W once per pixel and class, keeping a "
                   "running max whose first index wins"),
        # max_abs_err, for an argmax: the largest logit gap between the two
        # classes chosen where kernel and plain version disagree (0.0 where
        # they never do)
        **k1,
    }]
    ce_source = "structure_knowledge_distillation_tpu_torch/csrc/upsampled_ce.cu"
    pallas_ce = "structure_knowledge_distillation_tpu/ops/pallas_ce.py"
    # K4/K5 carry the train step; K2/K3 run only when the DSN heads differ in
    # shape, which the R18 student never does, so the train path counts 0 of
    # them. Errors: |loss − plain| for a forward, max |grad − plain| for a
    # backward, at the train shape in bf16; ms: device time of that kernel.
    fwd_design = ("ce_fwd_interval_kernel: a block per (image, low-res row interval, window of "
                  "512 columns) stages the two low-res rows, interpolates along H once per row "
                  "and along W once per pixel and class into registers, four classes at a "
                  "time, for the log-sum-exp and the picked logit; then ce_reduce_kernel")
    bwd_design = ("ce_bwd_interval_kernel: a block per (image, low-res row interval, column "
                  "segment) sums the corner gradients of its cells in shared memory; then "
                  "ce_bwd_combine_kernel")
    for key, name, line, design in (("K2", "upsampled_ce_loss (forward)", 183, fwd_design),
                                    ("K3", "upsampled_ce_loss (backward)", 227, bwd_design),
                                    ("K4", "upsampled_ce_loss_dsn (forward)", 315, fwd_design),
                                    ("K5", "upsampled_ce_loss_dsn (backward)", 362, bwd_design)):
        kernels.append({"name": name, "route": "cuda", "source": ce_source,
                        "replaces": f"{pallas_ce}:{line}", "path": "train",
                        "launches": train["launches"][key],
                        "on_main_path": key in ("K4", "K5"), "design": design, **ce[key]})
    # K6–K8: launches of the fused train step's timed steps plus the fused
    # eval sweep's; errors and times at the shapes phase_bn_kernel names
    bn_source = "structure_knowledge_distillation_tpu_torch/csrc/fused_bn.cu"
    pallas_bn = "structure_knowledge_distillation_tpu/ops/pallas_bn.py"
    for key, name, line in (("K6", "bn_act (fused ABN forward)", 73),
                            ("K7", "bn_grad_sums (fused ABN backward sums)", 117),
                            ("K8", "bn_grad_input (fused ABN backward dx)", 163)):
        train_n, eval_n = train_fused["launches"][key], eval_fused["launches"][key]
        kernels.append({"name": name, "route": "cuda", "source": bn_source,
                        "replaces": f"{pallas_bn}:{line}", "path": "fused-ABN train/eval",
                        "launches": train_n + eval_n, "train_launches": train_n,
                        "eval_launches": eval_n, **bn[key]})
    # K9: two kernels for one TPU kernel, chosen by dtype and channel counts;
    # each entry holds the first probe case it ran (wgmma: (8,256,256,64)->64
    # bf16; direct: the same conv in f32, and its bf16 time at that shape)
    csrc = "structure_knowledge_distillation_tpu_torch/csrc"
    for route, name, source in (("direct", "conv3x3", "conv3x3.cu"),
                                ("wgmma", "conv3x3 (wgmma)", "conv3x3_wgmma.cu")):
        kernels.append({"name": name, "route": "cuda", "source": f"{csrc}/{source}",
                        "replaces": "scripts/bench_pallas_conv.py:62", "path": "conv3x3 probe",
                        **k9[route]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
