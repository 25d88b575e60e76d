"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's two main paths on the card, in phases: the whole-image
eval path (`training/evaluate.py::evaluate_main`) at Cityscapes full
resolution, and the Pi+Pa+Ho distillation train step
(`training/trainer.py::KDTrainer.fit`) at the reference recipe. Each phase
prints one line and any failure ends the run with a non-zero exit:

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
     make_fast_val_fn;
  7. ce_kernel: the upsampled-CE kernels K4/K5 (two heads) and K2/K3 (one
     head) against their plain versions at the train shape, (8,19,65,65)
     logits → (8,512,512) labels, f32 and bf16, 5 % and 100 % ignored
     labels: loss within a relative 1e-5, low-res gradients within 1e-4 of
     their largest entry (f32) or one bf16 ulp of it (bf16), two runs
     bit-identical; warm median device times, forward and forward+backward;
  8. train: KDTrainer.fit at the reference recipe (batch 8, 512² crops,
     bf16 convs, Pi+Pa+Ho, wgan-gp) with a seeded random full-width R101
     teacher and seeded R18 student and discriminator: 2 warm-up steps, then
     5 timed steps; every loss finite, student and D parameters changed, and
     K4 and K5 launched once per step;
  9. train_gpu_vs_cpu: one f32 step of the CPU tests' small configuration on
     cuda (TF32 off) and on cpu from the same weights and GP α: losses and
     parameter updates agree.

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

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.models import (
    Discriminator,
    ResPSPNet,
    student_model,
    teacher_model,
)
from structure_knowledge_distillation_tpu_torch.ops import _build
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
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
# order, so they may disagree only where two classes tie
MISMATCH_SHARE_MAX = 1e-3
TIE_GAP_MAX = 1e-5
# GPU vs CPU forward in full f32 (TF32 off): cuDNN and the CPU's convolutions
# accumulate in different orders through ~20 layers
LOGITS_REL_TOL = 1e-3
CLASS_MAP_AGREEMENT_MIN = 0.999
# K2–K5 vs their plain versions: f32 sums in another order; in bf16 the
# gradient is one rounding of nearly the same f32 value
CE_LOSS_RTOL = 1e-5
CE_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}
TRAIN_SHAPE = (8, NUM_CLASSES, 65, 65)
TRAIN_CROP = (512, 512)
WARMUP_STEPS, TIMED_STEPS = 2, 5
# GPU vs CPU train step in f32 with TF32 off: the one-step envelope of the
# CPU parity tests (tests/test_torch_port_train_step.py)
STEP_LOSS_RTOL, STEP_LOSS_ATOL = 2e-3, 2e-4
STEP_UPDATE_REL_L2, STEP_UPDATE_COS, UPDATE_FLOOR = 2e-2, 0.999, 1e-4


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


def _ce_case(device, heads, dtype, ignored, seed):
    g = torch.Generator().manual_seed(seed)
    xs = [(2.0 * torch.randn(TRAIN_SHAPE, generator=g)).to(device, dtype).requires_grad_()
          for _ in range(heads)]
    labels = torch.randint(0, NUM_CLASSES, (TRAIN_SHAPE[0],) + TRAIN_CROP, generator=g)
    labels[torch.rand(labels.shape, generator=g) < ignored] = 255
    return xs, labels.to(device)


def phase_ce_kernel(device: torch.device) -> dict:
    """K2–K5 against the plain versions; returns the JSON fields per kernel."""
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
                cases.append({"case": name, "loss": loss.item(), "loss_abs_err": loss_err,
                              "grad_max_abs_err": grad_err, "grad_max": grad_max,
                              "bit_identical": True, "fwd_ms": fwd_ms,
                              "plain_fwd_ms": plain_fwd_ms, "bwd_ms": bwd_ms,
                              "plain_bwd_ms": plain_bwd_ms, "fwd_bwd_ms": fb_ms,
                              "plain_fwd_bwd_ms": plain_fb_ms})
                if dtype == torch.bfloat16:  # the train step's logits are bf16
                    record[k_fwd] = {"max_abs_err": loss_err, "ms": fwd_ms,
                                     "plain_ms": plain_fwd_ms}
                    record[k_bwd] = {"max_abs_err": grad_err, "ms": bwd_ms,
                                     "plain_ms": plain_bwd_ms}
    phase(7, "ce_kernel", shape=list(TRAIN_SHAPE), out=list(TRAIN_CROP), cases=cases)
    return record


def _train_config(**overrides) -> TrainConfig:
    kwargs = dict(data_set="synthetic", classes_num=NUM_CLASSES, batch_size=8,
                  input_size=TRAIN_CROP, compute_dtype="bfloat16", pi=True, pa=True, ho=True,
                  adv_loss_type="wgan-gp", device="cuda", log_every=1)
    kwargs.update(overrides)
    return TrainConfig(**kwargs)


def _flat_params(module: torch.nn.Module) -> torch.Tensor:
    return torch.cat([p.detach().reshape(-1).float() for p in module.parameters()])


def phase_train(device: torch.device) -> dict:
    cfg = _train_config()
    teacher = teacher_model(NUM_CLASSES, generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(teacher, 3)
    trainer = KDTrainer(cfg, teacher_state=teacher.state_dict())
    del teacher
    ds = SyntheticSegDataset((WARMUP_STEPS + TIMED_STEPS) * cfg.batch_size, TRAIN_CROP,
                             NUM_CLASSES, seed=0)
    batches = list(batch_iterator(ds, cfg.batch_size, shuffle=False))
    s_before, d_before = _flat_params(trainer.student), _flat_params(trainer.discriminator)

    trainer.fit(batches[:WARMUP_STEPS])
    torch.cuda.synchronize()
    upsampled_ce_loss_dsn.launches = upsampled_ce_loss_dsn.bwd_launches = 0
    upsampled_ce_loss.launches = upsampled_ce_loss.bwd_launches = 0
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    trainer.fit(batches[WARMUP_STEPS:])
    torch.cuda.synchronize()
    took = time.perf_counter() - t0
    launches = {"K4": upsampled_ce_loss_dsn.launches, "K5": upsampled_ce_loss_dsn.bwd_launches,
                "K2": upsampled_ce_loss.launches, "K3": upsampled_ce_loss.bwd_launches}

    steps = [m for _, m in trainer.history]
    check(len(steps) == WARMUP_STEPS + TIMED_STEPS, f"{len(steps)} logged steps")
    for m in steps:
        check(all(math.isfinite(v) for v in m.values()), f"a loss is not finite: {m}")
    check(not torch.equal(s_before, _flat_params(trainer.student)), "student unchanged")
    check(not torch.equal(d_before, _flat_params(trainer.discriminator)), "D unchanged")
    check(launches["K4"] == TIMED_STEPS and launches["K5"] == TIMED_STEPS,
          f"K4/K5 launched {launches['K4']}/{launches['K5']} times in {TIMED_STEPS} steps")
    phase(8, "train", model="R101 teacher -> R18 student, full width, bf16 convs",
          batch=cfg.batch_size, crop=list(TRAIN_CROP), steps=TIMED_STEPS,
          ms_per_step=1e3 * took / TIMED_STEPS,
          images_per_second=cfg.batch_size * TIMED_STEPS / took, launches=launches,
          max_memory_allocated=torch.cuda.max_memory_allocated(device),
          first_step=steps[0], last_step=steps[-1])
    return launches


def _small_state(device, sd=None) -> KDTrainState:
    cfg = _small_config(device)
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0,
                        generator=g)
    student = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, generator=g)
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


def phase_train_gpu_vs_cpu(device: torch.device) -> None:
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = _small_state("cpu")
        start = [{k: v.clone() for k, v in m.state_dict().items()}
                 for m in (cpu.teacher, cpu.student, cpu.discriminator)]
        gpu = _small_state(device, start)
        rng = np.random.RandomState(5)
        images = rng.randn(2, 3, 256, 256).astype(np.float32)
        images[1] = 3.0 * images[1] + 1.0  # two images of different statistics
        labels = rng.randint(0, 7, (2, 256, 256))
        labels[0, :16] = 255
        alpha = torch.from_numpy(rng.rand(2, 1, 1, 1).astype(np.float32))
        before = upsampled_ce_loss_dsn.launches
        m_gpu = make_train_step(_small_config(device))(
            gpu, torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device),
            alpha=alpha.to(device))
        check(upsampled_ce_loss_dsn.launches == before + 1, "the GPU step did not launch K4")
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
    phase(9, "train_gpu_vs_cpu", loss_rel_diff=loss_rel, worst_update_rel_l2=worst[0],
          worst_update_tensor=worst[1], loss_rtol=STEP_LOSS_RTOL,
          update_rel_l2_max=STEP_UPDATE_REL_L2, update_cos_min=STEP_UPDATE_COS,
          update_floor=UPDATE_FLOOR)


def main() -> int:
    phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    k1 = phase_kernel(device)
    launches = phase_slice(device)
    phase_gpu_vs_cpu(device)
    phase_teacher(device)
    ce = phase_ce_kernel(device)
    train_launches = phase_train(device)
    phase_train_gpu_vs_cpu(device)
    kernels = [{
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
    }]
    ce_source = "structure_knowledge_distillation_tpu_torch/csrc/upsampled_ce.cu"
    pallas_ce = "structure_knowledge_distillation_tpu/ops/pallas_ce.py"
    # K4/K5 carry the train step; K2/K3 run only when the DSN heads differ in
    # shape, which the R18 student never does, so the train path counts 0 of
    # them. Errors: |loss − plain| for a forward, max |grad − plain| for a
    # backward, at the train shape in bf16; ms: device time of that kernel.
    for key, name, line in (("K2", "upsampled_ce_loss (forward)", 183),
                            ("K3", "upsampled_ce_loss (backward)", 227),
                            ("K4", "upsampled_ce_loss_dsn (forward)", 315),
                            ("K5", "upsampled_ce_loss_dsn (backward)", 362)):
        kernels.append({"name": name, "route": "cuda", "source": ce_source,
                        "replaces": f"{pallas_ce}:{line}", "launches": train_launches[key],
                        "on_main_path": key in ("K4", "K5"), **ce[key]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
