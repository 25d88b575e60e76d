"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for H100, sm_90a).

    python3 chip_smoke.py

Drives the port's main paths on the card, in phases: the whole-image eval
path (`training/evaluate.py::evaluate_main`) at Cityscapes full resolution,
the Pi+Pa+Ho distillation train step (`training/trainer.py::KDTrainer.fit`)
at the reference recipe, both again with the fused ABN (`bn_fused=True`,
kernels K6–K8), the conv3x3 probe (K9), the whole training run through
the train CLI from Cityscapes-shaped frames on disk (loader workers,
prefetch, checkpoints, SIGTERM and resume), the multi-step loop as
CUDA-graph replays (`--unroll-steps`), the other inference modes
(multiscale+flip, sliding tiles, batched groups, the u8 image wire, the
test-set submission of `cli.test`), and the CamVid ESPNet-C distillation
recipe with OHEM, `--remat` and the VOC CLIs, data parallelism over
processes, and the inference export (the BN fold and a `torch.export`
serving program). Each phase prints one line
(phases 17 and 18 one a part) and any failure ends the run with a non-zero
exit:

  1. device: CUDA must be available; prints the card's name and power limit,
     the torch/CUDA versions and the TF32 flags as set;
  2. build: compiles csrc/*.cu with nvcc (ops/_build.py) and prints the time;
  3. kernel: upsampled_argmax (K1) against upsampled_argmax_plain on the card
     at the eval path's shapes, f32 and bf16, plain and quantised (tied)
     logits, and at evaluate_sharded's batch of 8 in f32 (its time and
     bound in K1's `batch8` entry); mismatches must be < 1e-3 of the pixels and true ties (< 1e-5),
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
     must show no spill;
 15. train_cityscapes: the real training run through `cli.train.main` on a
     fake Cityscapes tree written from a seed (16 train and 2 val frames at
     1024×2048, PNGs that decode like real frames), with a seeded R101
     teacher saved as a `.pth` and passed as --T_ckpt_path: random scale
     and mirror in the native augmentation, 4 spawned loader workers, the
     decode cache, batch 8, 512² crops, bf16, Pi+Pa+Ho, wgan-gp, the bf16 +
     uint8 wire through the pinned-memory prefetch, 6 steps with an eval
     every 2. Leg 1 is sent SIGTERM after step 3: it must return with the
     full state saved at step 3, `model_best.pth.tar` and the step-2 cadence
     snapshot written, the SIGTERM handler restored and no worker process
     left. Leg 2 (--S_resume true, no explicit student checkpoint, so the
     auto-resume stream) must train exactly steps 4–6 with finite losses and
     one K4 and one K5 launch per step. A fresh student must load
     `model_best.pth.tar` strictly and score on the val frames exactly the
     mIoU logged for it. Prints the host loader's images/s (numpy vs native,
     serial vs 4 workers, no, cold and warm cache), the H2D time of one batch
     (pageable f32 vs pinned bf16 + uint8 on a side stream), leg 2's step
     times, and each checkpoint's save ms and size, with the card's name and
     power limit;
 16. train_loop: the multi-step loop (`make_train_loop`, unroll 4) on phase
     11's models. Equivalence: after the loop's eager warm-up chunk, a copy
     of the fused state takes 4 eager `train_step`s (every uniform they draw
     recorded) while the original's next chunk is captured as one CUDA
     graph and replayed: the replay's lrs and uniforms (so its dropout masks
     and α) must equal the eager ones bit for bit, the generators must end
     equal, the losses must agree within phase 9's rtol/atol and every
     tensor (parameters, momentum, u/v, running statistics) within 2 % in
     its change over the chunk, with phase 9's floor.
     Timing: for the fused and the unfused state, eager and graph chunks in
     turns, three each, unprofiled (ms per step, img/s, capture ms, peak
     memory), then one profiled chunk of each (device busy share: the union
     of kernel and copy intervals over the profiled wall, and over the
     unprofiled median wall, which the profiler's host cost does not
     stretch). One profiled fused replay
     must hold K4 = K5 = 4, K6 = 141·4, K7 = K8 = 29·4 launches, counted by
     kernel name (the Python counters count a captured kernel once, at
     capture), and an unfused one K4 = K5 = 4 and no K6–K8. Last the train CLI
     with --unroll-steps 4 --profile-dir over 14 synthetic steps at full
     width: the eager chunk, a capture and its replay, a replay, an eager
     tail of 2; finite losses logged at steps 1–14, the eval at step 13, the
     loop's log of 8 replayed and 6 eager steps, and one trace file that
     names K4's kernel;
 17. eval_modes: phase 4's student (f32) on fake 1024×2048 Cityscapes frames
     written from a seed (9 val, 2 test), one line a part with ms per frame,
     `max_memory_allocated` and the launches counted over that part alone:
     (1) the fast path on the f32 and the u8 wire: the two int64
     confusions equal exactly, K1 once a frame; the H2D ms of one frame
     (pageable f32, pinned f32, pinned u8); (2) multiscale (0.75, 1.0,
     1.25) + flip; msf at (1.0,) without flip against the fast path: class
     maps agree in ≥ 0.999, mIoU within 1e-3; (3) sliding 512² tiles (18 a
     frame); one whole-frame tile's class maps bit-equal to msf at (1.0,);
     (4) evaluate_sharded, groups of 8 over the 9 frames (a tail group with
     7 masked slots): the pixel count exact, mIoU within 1e-3 of
     evaluate_main's, K1 launched exactly twice; one msf group of 8 against
     evaluate_main's msf over the same frames; (5) cli.test over the 2 test
     frames: two 1024×2048 palette PNGs of labelIds; (6) the u8 train wire:
     two uint8 chunks of 4 batches (512² crops of the frames) through
     make_train_loop on phase 11's fused models, and the same chunks
     de-quantized on the host to bf16 through a second loop on a copy of
     the state; each an eager chunk, a capture of its own and its replay;
     every loss and state tensor bit-equal;
 18. camvid_espnet: the CamVid ESPNet-C recipe (scripts/run_camvid_espnet.sh)
     at full width, one line a part: (1) the R101 teacher and the ESPNet-C
     student (p=2, q=8) at 11 classes, batch 8, 360×480, bf16, Pi+Pa, ho
     false: after the loop's eager warm-up chunk (unroll 4), a copy of the
     state takes 4 eager steps while the loop captures and replays the same
     chunk (phase 16's rules); one step launches exactly 2 K2 and 2 K3
     (heads 45×60 and 90×120, from the teacher's 46×61 grid resized to the
     student's 45×60) and no K4/K5, and a step draws no uniform; eager and
     replay ms per step, img/s, peak memory; one eager ho step (wgan-gp, D
     at image_size 46 on the 45×60 logits) with finite losses; (2) K2/K3 at
     the two CamVid head shapes against their plain versions (phase 7's
     tolerances and bound), per head and summed per step; (3) phase 9's
     GPU-vs-CPU step with the full ESPNet-C (7 classes) as the student at
     256²; (4) an R18 step at the reference recipe with OHEM (min_kept
     100000: k = 1562), eager and as a replay, and `criterion_ohem_dsn` on
     the card against the CPU, its threshold printed; (5) an R18 step with
     and without `remat` from copies of one state: phase 16's rules, the
     running statistics moved once; the ms, peak memory, the peak of each
     interval between module forwards and the bytes a student forward holds
     for its backward, of each; (6) `cli.train` on a fake
     CamVid tree (360×480 PNGs, void class 11) with the recipe's flags and
     --unroll-steps 4 (an eager chunk, a capture and its replay, the eval at
     360×480: K1 once a val frame), the CamVid u8 eval wire's confusion
     equal to the f32 one, `cli.eval --data-set voc` (R18 at 21 classes,
     505×505) and `cli.test --data-set voc` (one class-id PNG a test id);
 19. data_parallel: phase 11's fused models through the data-parallel path
     (`parallel/`, sync BN, rank shares, the flat gradient all-reduce). (a)
     A world-1 NCCL group: the loop (unroll 4) with ABN groups set, an eager
     chunk, a capture and its replay, against phase 16's loop from the same
     state on the same chunks: every tensor bit-equal (every share is ×1),
     the collectives per step and their bytes, both captures' ms, replays
     timed in turns (ms per step, img/s), a profiled replay of each (busy
     share, K4–K8 counted by name) and the Python counts of an eager step.
     (b) Two gloo ranks on the one card (CUDA tensors; eager: gloo cannot be
     captured), batch 4 each, against the one-process step at batch 8 on
     the same card, both in f32 with TF32 off (phase 9's setting): losses
     within phase 9's rtol/atol, updates within 2 % (phase 16's rule and
     floor), the ranks bit-identical, K4/K5 once and K6–K8 at the fused
     counts a rank step. (c) With N ≥ 2 cards, N NCCL ranks, one a card
     (`nvidia-smi topo -m` printed first): batch 8/N a rank in f32 (an
     eager step, then a captured one and its replay) against the one-card
     batch-8 loop (the eager step at phase 9's tolerances and the 2 % rule;
     the replayed step, which starts from each side's own first update, at
     the port's second-step envelope), the ranks' states equal by digest;
     batch 8 a rank in bf16 replayed (ms per step, img/s over the N cards,
     capture ms, busy share, K4–K8 per replay); `cli.train
     --num-data-shards N` on synthetic crops (a checkpoint at step 2, a
     resume to step 4) and `cli.eval --num-data-shards N` on fake frames,
     whose mIoU must equal the one-card sweep's. On one card (c) prints one
     line saying it did not run. `python3 chip_smoke.py --only
     data_parallel` runs phases 1, 2 and 19 alone (the four-card run).
 20. export: phase 4's student (seeded weights, random running statistics)
     and the inference export. (a) The fold on the card: the folded model's
     (`ResPSPNet(fold_bn=True)`, `models/fold.py`) logits on a 1024×2048
     frame within 1e-3 of max(max |logit|, 1) of the unfolded ones with TF32
     off (cli.export's rule; the TF32 difference printed beside), its
     evaluate_main mIoU over phase 4's frames within 1e-3 of the unfolded
     model's, K1 launched once a frame and K6 never. (b) `cli.export.main`
     on the card with --fold-bn and a classmap program at (1, 1024, 2048, 3),
     in f32 and in bf16: each `.pt2` runs in a fresh `python3` in which
     importing the port raises; the f32 program's class maps differ from
     the folded K1 fast path's in at most 1e-3 of the pixels, the bf16
     program's from the port's bf16 folded eager model through the same
     resize and argmax likewise; the fast path's maps after the export equal
     those before it and the resize cache holds real tensors; the export
     seconds and `.pt2` bytes printed. (c) ms per frame in turns (3 turns, 4
     frames a sweep, host clock, pinned copies): the unfolded, `bn_fused`
     and folded fast paths and the f32 and bf16 programs, then one profiled
     sweep of each (device busy ms a frame and busy share). (d) The R101
     teacher's eval forward at batch 8, 512², bf16, no grad: unfolded,
     `bn_fused` and folded, device ms in turns, and one profiled forward of
     each (kernel ms, launches, the top kernels by time); the folded f32
     logits within 1e-3 (relative, TF32 off) of the unfolded ones. Times print beside the
     card's name and power limit. `--only export` runs phases 1, 2 and 20.

Every kernel's JSON entry carries `bound_ms`, the least time an H100 SXM
could take for the call (`card_bound`: its bytes over 3.35 TB/s or its
operations over the peak of their type, whichever is longer, counted from
this run's inputs), `bound_by`, and `library_ms`, the time of one PyTorch
call that computes the same function where one exists (else null). The
last two lines are the kernels' JSON record and the contract line
{"ok": true, "device": {...}}. The script imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import copy
import hashlib
import inspect
import io
import json
import logging
import math
import multiprocessing
import os
import signal
import statistics
import re
import subprocess
import sys
import tempfile
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch
import torch.nn.functional as F

from PIL import Image

from structure_knowledge_distillation_tpu_torch.cli import eval as eval_cli
from structure_knowledge_distillation_tpu_torch.cli import export as export_cli
from structure_knowledge_distillation_tpu_torch.cli.export import no_tf32
from structure_knowledge_distillation_tpu_torch.cli import test as test_cli
from structure_knowledge_distillation_tpu_torch.cli import train as train_cli
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import (
    CAMVID_MEAN,
    IMG_MEAN_BGR,
    CamVidDataset,
    CityscapesDataset,
    SyntheticSegDataset,
    batch_iterator,
    cast_batches,
    chunk_batches,
    make_cityscapes_lists,
    quantize_u8,
    to_nchw,
    trainid2id,
    warm_cache,
)
from structure_knowledge_distillation_tpu_torch.models import (
    BASIC,
    BOTTLENECK,
    Discriminator,
    ESPNetC,
    ResPSPNet,
    fold_bn_state_dict,
    student_model,
    teacher_model,
)
from structure_knowledge_distillation_tpu_torch.losses.ohem import criterion_ohem_dsn, ohem_threshold
from structure_knowledge_distillation_tpu_torch.ops import _build, fused_bn
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
    ABN,
    _moments,
    abn_normalize,
    abn_train,
    set_process_group,
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
from structure_knowledge_distillation_tpu_torch.ops.resize import (
    interp_matrix_align_corners,
    resize_bilinear_align_corners,
)
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
from structure_knowledge_distillation_tpu_torch.parallel import (
    all_reduce_sum,
    launch,
    shard_rows,
    world_of,
)
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt_io
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    _tile_grid,
    evaluate_main,
    evaluate_sharded,
    iu_from_confusion,
    make_fast_val_fn,
    make_msf_val_fn,
    make_sliding_val_fn,
)
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    momentum_buffers,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)
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
K1_GROUP = 8  # evaluate_sharded's group: one K1 launch of batch 8
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
TRAIN_BATCH = 8
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
# phase 15: fake 1024×2048 Cityscapes frames (train, val) through the train
# CLI with 4 loader workers; leg 1 is sent SIGTERM after step 3 of 6, leg 2
# resumes; the worker-pool loader rates count 8 batches
CS_FRAMES = (("train", 16), ("val", 2))
CS_WORKERS = 4
CS_STEPS, CS_EVAL_EVERY, CS_SIGTERM_AFTER = 6, 2, 3
CS_LOADER_BATCHES = 8
# phase 16: the multi-step loop at unroll 4. Eager steps and a replay of
# the same chunk from copies of one state run the same kernels in the same
# order, but cuDNN's weight-gradient kernels sum with atomics in an order
# that changes from run to run, and over 4 GAN steps in bf16 such roundings
# grow: every tensor is held to phase 9's 2 % (relative L2 of its change
# over the chunk, with phase 9's floor), the losses to phase 9's rtol/atol.
# By the change and not the value: D's u/v and the running statistics move
# about 1e-4 of their value in 4 steps, so a graph that left them as they
# were would pass a comparison of values. The graph's own kernels are
# counted from a profiled replay.
LOOP_UNROLL = 4
LOOP_TENSOR_REL = 2e-2
LOOP_TURNS = 3
LOOP_CLI_STEPS = 14
GRAPH_KERNELS = {"K4": "ce_fwd_interval_kernel", "K5": "ce_bwd_interval_kernel",
                 "K6": "bn_fwd_kernel", "K7": "bn_sums_kernel", "K8": "bn_bwd_kernel"}
STEP_RANGES = ("teacher_forward", "student_loss_and_grad", "d_loss_and_grad")
# phase 17: the other inference modes on fake 1024×2048 Cityscapes frames: 9
# val frames (one full group of 8 in evaluate_sharded and a tail group with 7
# masked slots) and 2 test frames; scales and tile of the reference's
# published eval
EM_FRAMES = (("val", 9), ("test", 2))
EM_SCALES = (0.75, 1.0, 1.25)
EM_TILE = (512, 512)
HBM_BYTES_PER_S = 3.35e12
SLEEP_CYCLES_PER_S = 2.0e9  # above the H100 SXM's 1.98 GHz boost clock
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
    events around `reps` back-to-back calls. Each trial first queues a
    device sleep (at least ~10 ms, and at least twice the host time that
    `reps` calls took to enqueue, measured once first: an autograd backward
    on a loaded host can take longer than 10 ms to enqueue 20 times), so all
    `reps` calls are enqueued before the device reaches them and the host's
    launch overhead stays out of the number (in the eval path the forward's
    device work hides it the same way)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    # _sleep counts SM clock cycles; at most SLEEP_CYCLES_PER_S of them a second
    cycles = max(20_000_000, int(2 * enqueue_s * SLEEP_CYCLES_PER_S))
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
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


def phase_device() -> str:
    """Phase 1; returns nvidia-smi's name and power limit line."""
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
    return smi_line


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
    cases, max_gap, headline, batch8 = [], 0.0, None, None
    both = (torch.float32, torch.bfloat16)
    # batch 8: evaluate_sharded's single-scale groups (phase 17)
    for shape, out, dtypes in (((1, NUM_CLASSES, 129, 257), FULL_RES, both),
                               ((K1_GROUP, NUM_CLASSES, 129, 257), FULL_RES, (torch.float32,)),
                               ((2, NUM_CLASSES, 65, 65), (512, 512), both)):
        for dtype in dtypes:
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
                if out == FULL_RES and not quantised and (
                        headline is None or (shape[0] == K1_GROUP and batch8 is None)):
                    # (N,19,129,257)->(1024,2048) f32: the eval path's
                    # separable resize (a lerp of 3 operations per sample,
                    # along H on the input's columns, then along W) and a
                    # compare per class and output pixel
                    n, c, h_in, w_in = shape
                    flops = n * c * out[0] * (3 * w_in + 3 * out[1] + out[1])
                    # no one PyTorch call upsamples and takes the argmax
                    timed = {"ms": ms, "plain_ms": plain_ms, "library_ms": None,
                             **card_bound(x.nbytes + k.nbytes, flops)}
                    timed["bound_share"] = timed["bound_ms"] / ms
                    if headline is None:
                        headline = timed
                        check(plain_ms >= K1_SPEEDUP_MIN * ms,
                              f"K1 {name}: {ms} ms is not {K1_SPEEDUP_MIN}x faster than the "
                              f"plain version's {plain_ms} ms")
                    else:
                        batch8 = {"shape": list(shape), **timed}
    phase(3, "kernel", cases=cases, ptxas=k1_ptxas)
    return {"max_abs_err": max_gap, **headline, "batch8": batch8}


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
    kwargs = dict(data_set="synthetic", classes_num=NUM_CLASSES, batch_size=TRAIN_BATCH,
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


def _small_state(device, sd=None, bn_fused: bool = False, espnet: bool = False) -> KDTrainState:
    """Phase 9's small teacher and D with the small R18 student, or with the
    full ESPNet-C (p=2, q=8) as the student."""
    cfg = _small_config(device)
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0,
                        generator=g, bn_fused=bn_fused)
    student = (ESPNetC(7, generator=g) if espnet else
               ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, generator=g,
                         bn_fused=bn_fused))
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


def _gpu_vs_cpu_step(device: torch.device, bn_fused: bool = False,
                     espnet: bool = False) -> dict:
    """One f32 step (TF32 off) of `_small_state` on the card and on the CPU
    from the same weights, batch and GP α: losses within STEP_LOSS_RTOL/ATOL,
    every parameter update within STEP_UPDATE_REL_L2 and STEP_UPDATE_COS."""
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        cpu = _small_state("cpu", bn_fused=bn_fused, espnet=espnet)
        start = [{k: v.clone() for k, v in m.state_dict().items()}
                 for m in (cpu.teacher, cpu.student, cpu.discriminator)]
        gpu = _small_state(device, start, bn_fused, espnet)
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
        # the R18 heads agree in shape (K4 once); ESPNet-C's differ (K2 twice)
        want = {"K2": 2, "K3": 2, "K4": 0} if espnet else {"K4": 1}
        check(all(counts[k] == n for k, n in want.items()),
              f"the GPU step launched {counts}, expected {want}")
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
    return {"loss_rel_diff": loss_rel, "worst_update_rel_l2": worst[0],
            "worst_update_tensor": worst[1]}


def phase_train_gpu_vs_cpu(device: torch.device, bn_fused: bool = False) -> None:
    phase(12 if bn_fused else 9, "train_fused_gpu_vs_cpu" if bn_fused else "train_gpu_vs_cpu",
          **_gpu_vs_cpu_step(device, bn_fused), loss_rtol=STEP_LOSS_RTOL,
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


def write_fake_cityscapes(root: str, frames=CS_FRAMES, size=FULL_RES, seed: int = 0) -> None:
    """Cityscapes' tree under `root`, from a seed: `leftImg8bit/{split}/
    {city}/*_leftImg8bit.png` frames of smooth BGR structure (a 17×33 field
    upsampled bicubically) under noise of σ 12, so a frame's PNG decode costs
    about what a real frame's does, and `gtFine/.../*_gtFine_labelIds.png`
    labelIds 0..33 in blocks (a 17×33 draw upsampled nearest)."""
    import cv2

    h, w = size
    jobs = [(split, i, k) for k, (split, i) in
            enumerate((split, i) for split, n in frames for i in range(n))]

    def write(job) -> None:
        split, i, k = job
        rng = np.random.default_rng((seed, k))
        field = rng.uniform(0, 255, (17, 33, 3)).astype(np.float32)
        image = cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC)
        image += rng.normal(0.0, 12.0, image.shape).astype(np.float32)
        ids = rng.integers(0, 34, (17, 33)).astype(np.uint8)
        label = cv2.resize(ids, (w, h), interpolation=cv2.INTER_NEAREST)
        city = f"city{i % 2}"
        stem = f"{city}_{i:06d}_000019"
        for sub, suffix, arr in (("leftImg8bit", "leftImg8bit", np.clip(image, 0, 255)),
                                 ("gtFine", "gtFine_labelIds", label)):
            d = os.path.join(root, sub, split, city)
            os.makedirs(d, exist_ok=True)
            check(cv2.imwrite(os.path.join(d, f"{stem}_{suffix}.png"), arr.astype(np.uint8)),
                  f"cv2.imwrite failed under {d}")

    with ThreadPoolExecutor(8) as pool:
        list(pool.map(write, jobs))


def _loader_rates(root: str, train_list: str, work: str) -> tuple:
    """Host images/s of the train loader at the run's crop and batch: serial
    (numpy and native augmentation; no cache, a cold cache, a warm one) over
    one batch, and `CS_WORKERS` workers (native; no cache, a warm cache)
    over `CS_LOADER_BATCHES` batches, counted from the batch that ends the
    pool's first round (its start-up, `first_batch_seconds`, left out).
    Returns (rows, the native serial loader's batch)."""
    rows, sample = [], None
    cache = os.path.join(work, "rate_cache")
    for name, native, cache_dir in (("numpy, serial, no cache", False, None),
                                    ("native, serial, no cache", True, None),
                                    ("native, serial, cold cache", True, cache),
                                    ("native, serial, warm cache", True, cache)):
        ds = CityscapesDataset(root, train_list, crop_size=TRAIN_CROP, seed=0,
                               use_native=native, cache_dir=cache_dir)
        batches = batch_iterator(ds, TRAIN_BATCH, seed=0)
        t0 = time.perf_counter()
        batch = next(batches)
        took = time.perf_counter() - t0
        batches.close()
        sample = batch if native and sample is None else sample
        rows.append({"loader": name, "images": TRAIN_BATCH, "seconds": took,
                     "images_per_second": TRAIN_BATCH / took})
    warm_cache(CityscapesDataset(root, train_list, crop_size=TRAIN_CROP, cache_dir=cache))
    for name, cache_dir in ((f"native, {CS_WORKERS} workers, no cache", None),
                            (f"native, {CS_WORKERS} workers, warm cache", cache)):
        ds = CityscapesDataset(root, train_list, max_iters=CS_LOADER_BATCHES * TRAIN_BATCH,
                               crop_size=TRAIN_CROP, seed=0, cache_dir=cache_dir)
        t0 = time.perf_counter()
        arrived = []
        for _ in batch_iterator(ds, TRAIN_BATCH, seed=0, num_workers=CS_WORKERS):
            arrived.append(time.perf_counter())
        counted = len(arrived) - CS_WORKERS
        took = arrived[-1] - arrived[CS_WORKERS - 1]
        rows.append({"loader": name, "images": counted * TRAIN_BATCH, "seconds": took,
                     "images_per_second": counted * TRAIN_BATCH / took,
                     "first_batch_seconds": arrived[0] - t0})
    check(multiprocessing.active_children() == [], "the loader left worker processes behind")
    return rows, sample


def _copy_ms(fn, stream, trials: int = 5) -> float:
    """Median device time of `fn()`'s copies, CUDA events on `stream`."""
    times = []
    for _ in range(trials + 1):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record(stream)
        fn()
        end.record(stream)
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times[1:])


def _host_ms(fn, reps: int = 5) -> tuple:
    """(median host ms of `fn()` over `reps` calls after a first one, its
    last result)."""
    times = []
    for _ in range(reps + 1):
        t0 = time.perf_counter()
        out = fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times[1:]), out


def _h2d(device: torch.device, batch: tuple) -> dict:
    """One train batch host → device: the pageable f32 images and int32 labels
    that `KDTrainer.fit` copied before (on the step's stream), against the
    narrowed wire that `device_prefetch` moves (bf16 images, uint8 labels,
    pinned, on a side stream). Host ms of the cast and the pinning beside
    (medians; the first pinning also allocates the pinned block)."""
    images, labels = torch.from_numpy(batch[0]), torch.from_numpy(batch[1])
    current, side = torch.cuda.current_stream(device), torch.cuda.Stream(device)
    pageable_ms = _copy_ms(lambda: (images.to(device), labels.to(device)), current)
    cast_ms, narrow = _host_ms(
        lambda: next(cast_batches(iter([(images, labels)]), torch.bfloat16, torch.uint8)))
    pin_ms, pinned = _host_ms(lambda: [t.pin_memory() for t in narrow])

    def side_copy():
        with torch.cuda.stream(side):
            for t in pinned:
                t.to(device, non_blocking=True)

    pinned_ms = _copy_ms(side_copy, side)
    return {"pageable_f32_bytes": images.nbytes + labels.nbytes, "pageable_f32_ms": pageable_ms,
            "pinned_narrow_bytes": sum(t.nbytes for t in pinned), "pinned_narrow_ms": pinned_ms,
            "host_cast_ms": cast_ms, "host_pin_ms": pin_ms}


class _SigtermAfter(logging.Handler):
    """Sends this process SIGTERM when the trainer logs step `step`, as a
    preemption notice that arrives mid-run."""

    def __init__(self, step: int):
        super().__init__()
        self.step = step

    def emit(self, record: logging.LogRecord) -> None:
        if str(record.msg).startswith("step:") and record.args and record.args[0] == self.step:
            os.kill(os.getpid(), signal.SIGTERM)


def _scalars(log_dir: str) -> list:
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


def _timed_saves(saves: list):
    """`checkpoint.save_torch` wrapped to record each file's ms and bytes."""
    real = ckpt_io.save_torch

    def save_torch(obj, path):
        t0 = time.perf_counter()
        out = real(obj, path)
        saves.append({"file": os.path.relpath(path, os.path.dirname(os.path.dirname(path))),
                      "ms": 1e3 * (time.perf_counter() - t0), "bytes": os.path.getsize(path)})
        return out

    return real, save_torch


def phase_train_cityscapes(device: torch.device, card: str, synthetic_step_ms: float) -> dict:
    """The train CLI on a fake Cityscapes tree, in two legs: leg 1 stops on a
    SIGTERM after step `CS_SIGTERM_AFTER`, leg 2 resumes (`--S_resume true`,
    no explicit student checkpoint, so the auto-resume stream) and trains
    the steps left. Then a fresh student loads `model_best.pth.tar` strictly
    and must reproduce the mIoU logged for it."""
    trainer_log = logging.getLogger("structure_knowledge_distillation_tpu_torch.training.trainer")
    with tempfile.TemporaryDirectory(prefix="skd_cityscapes_") as work:
        root = os.path.join(work, "cityscapes")
        t0 = time.perf_counter()
        write_fake_cityscapes(root)
        write_s = time.perf_counter() - t0
        lists = make_cityscapes_lists(root, os.path.join(work, "list"))
        rates, host_batch = _loader_rates(root, lists["train"], work)
        h2d = _h2d(device, host_batch)

        teacher = teacher_model(NUM_CLASSES, generator=torch.Generator().manual_seed(2))
        randomize_bn_stats(teacher, 3)
        teacher_path = os.path.join(work, "teacher.pth")
        torch.save(teacher.state_dict(), teacher_path)
        del teacher
        snap = os.path.join(work, "snap")
        common = ["--data-set", "cityscapes", "--data-dir", root,
                  "--data-list", os.path.join(work, "dataset", "train.lst"),
                  "--val-data-list", os.path.join(work, "dataset", "val.lst"),
                  "--random-scale", "--random-mirror", "--num-workers", str(CS_WORKERS),
                  "--decode-cache-dir", os.path.join(work, "cache"),
                  "--batch-size", str(TRAIN_BATCH), "--input-size", "%d,%d" % TRAIN_CROP,
                  "--T_ckpt_path", teacher_path, "--S_ckpt_path", "", "--snapshot-dir", snap,
                  "--num-steps", str(CS_STEPS), "--eval-every", str(CS_EVAL_EVERY),
                  "--log-every", "1", "--device", device.type]
        saves: list = []
        real_save, ckpt_io.save_torch = _timed_saves(saves)
        sigterm = _SigtermAfter(CS_SIGTERM_AFTER)
        prev_handler = signal.getsignal(signal.SIGTERM)
        trainer_log.addHandler(sigterm)
        try:
            t0 = time.perf_counter()
            train_cli.main(common + ["--log-path", os.path.join(work, "log1")])
            leg1_s = time.perf_counter() - t0
            trainer_log.removeHandler(sigterm)
            check(signal.getsignal(signal.SIGTERM) == prev_handler,
                  "fit did not restore the SIGTERM handler")
            check(multiprocessing.active_children() == [], "leg 1 left worker processes behind")
            leg1 = _scalars(os.path.join(work, "log1"))
            latest = ckpt_io.latest_auto_resume(os.path.join(snap, "latest"))
            check(latest is not None and latest.endswith(f"step_{CS_SIGTERM_AFTER:08d}.pth"),
                  f"the newest auto-resume file is {latest}")
            check(ckpt_io.load_torch_checkpoint(latest)[1]["state_step"] == CS_SIGTERM_AFTER,
                  "the preemption save is not at the stopped step")
            check(os.path.isfile(os.path.join(snap, "model_best.pth.tar")), "no model_best")
            check(any(n.startswith(f"CS_scenes_{CS_EVAL_EVERY}_") and n.endswith(".pth")
                      for n in os.listdir(snap)), "no cadence snapshot at the first eval")
            check([r["step"] for r in leg1 if "g_loss" in r] == list(range(1, CS_SIGTERM_AFTER + 1)),
                  f"leg 1 trained steps {[r['step'] for r in leg1 if 'g_loss' in r]}")

            zero_counts()
            t0 = time.perf_counter()
            train_cli.main(common + ["--S_resume", "true", "--log-path", os.path.join(work, "log2")])
            leg2_s = time.perf_counter() - t0
            launches = read_counts()
        finally:
            trainer_log.removeHandler(sigterm)
            ckpt_io.save_torch = real_save
        check(multiprocessing.active_children() == [], "leg 2 left worker processes behind")
        leg2 = _scalars(os.path.join(work, "log2"))
        steps = [r for r in leg2 if "g_loss" in r]
        resumed = list(range(CS_SIGTERM_AFTER + 1, CS_STEPS + 1))
        check([r["step"] for r in steps] == resumed, f"leg 2 trained steps {[r['step'] for r in steps]}")
        for r in steps:
            check(all(math.isfinite(v) for v in r.values()), f"a loss is not finite: {r}")
        check(launches["K4"] == len(resumed) and launches["K5"] == len(resumed),
              f"K4/K5 launched {launches['K4']}/{launches['K5']} times in {len(resumed)} steps")

        sd, meta = ckpt_io.load_torch_checkpoint(os.path.join(snap, "model_best.pth.tar"))
        student = student_model(NUM_CLASSES, device=device, dtype=torch.bfloat16)
        skipped = ckpt_io.load_reference_state_dict(student, sd)
        check(not skipped and sorted(sd) == sorted(student.state_dict()),
              f"model_best does not load strictly: {skipped[:3]}")
        val = CityscapesDataset(root, lists["val"], crop_size=FULL_RES, scale=False, mirror=False)
        miou, _, _ = evaluate_main(student.eval(), batch_iterator(val, 1, shuffle=False),
                                   NUM_CLASSES, out_size=FULL_RES)
        logged = {r["step"]: r["val_mean_iu"] for r in leg1 + leg2 if "val_mean_iu" in r}
        check(miou == logged.get(meta["step"]),
              f"model_best (step {meta['step']}) scores {miou}, logged {logged}")

        sizes = {os.path.relpath(os.path.join(d, n), snap): os.path.getsize(os.path.join(d, n))
                 for d, _, names in os.walk(snap) for n in names}
    walls = {r["step"]: r["wall_time"] for r in leg1 + leg2 if "g_loss" in r}
    step_ms = {s: 1e3 * (walls[s] - walls[s - 1]) for s in resumed[1:]}
    stats = {"card": card, "write_fake_frames_s": write_s, "loader": rates, "h2d": h2d,
             "leg1_s": leg1_s, "leg2_s": leg2_s,
             "leg2_step_ms": step_ms,  # step s: from step s-1's log to step s's, an eval at s-1 included
             "leg2_images_per_second": {r["step"]: r["img_per_sec"] for r in steps},
             "steady_step_ms": step_ms[CS_STEPS], "synthetic_step_ms_phase8": synthetic_step_ms,
             "device_idle_share": "not measured",
             "launches": {k: launches[k] for k in ("K1", "K4", "K5")},
             "losses_last": {k: steps[-1][k] for k in ("g_loss", "d_loss", "mc_loss")},
             "model_best_step": meta["step"], "model_best_miou": miou,
             "saves": saves, "files": sizes}
    phase(15, "train_cityscapes",
          model="R101 teacher (.pth) -> R18 student, full width, bf16, from 1024x2048 frames",
          frames={s: n for s, n in CS_FRAMES}, batch=TRAIN_BATCH, crop=list(TRAIN_CROP),
          workers=CS_WORKERS, steps=CS_STEPS, sigterm_after=CS_SIGTERM_AFTER, **stats)
    return stats


def _full_state(cfg, device: torch.device, bn_fused: bool,
                dtype: torch.dtype = torch.bfloat16) -> tuple:
    """Phase 11's models, fused or not: the R101 teacher from seed 2 with
    phase 8's running statistics, student and D drawn from a generator
    seeded as `KDTrainer` seeds it, computing in `dtype`; returns (state,
    generator)."""
    teacher = ResPSPNet(BOTTLENECK, tuple(cfg.teacher_layers), NUM_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(2), dtype=dtype,
                        bn_fused=bn_fused)
    randomize_bn_stats(teacher, 3)
    teacher.requires_grad_(False)
    gen = torch.Generator().manual_seed(cfg.seed)
    student = ResPSPNet(BASIC, (2, 2, 2, 2), NUM_CLASSES, device=device, dtype=dtype,
                        generator=gen, bn_fused=bn_fused)
    disc = Discriminator(NUM_CLASSES, preprocess_mode=cfg.preprocess_gan_mode,
                         image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim, dtype=dtype,
                         device=device, generator=gen)
    state = KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    return state, gen


def _device_chunks(cfg, n: int, device: torch.device, seed: int = 4) -> list:
    """n chunks of LOOP_UNROLL synthetic batches of `cfg`'s crop and classes
    on the card, as the CLI's wire makes them: bf16 NCHW images, uint8
    labels."""
    ds = SyntheticSegDataset(n * LOOP_UNROLL * cfg.batch_size, tuple(cfg.input_size),
                             cfg.classes_num, seed=seed)
    chunks = chunk_batches(cast_batches(batch_iterator(ds, cfg.batch_size, shuffle=False),
                                        torch.bfloat16, torch.uint8), LOOP_UNROLL)
    return [(to_nchw(c.images.to(device)), c.labels.to(device)) for c in chunks]


def _loop_state(state: KDTrainState) -> dict:
    """Every parameter and buffer of student and D, and both momentum sets."""
    out = {}
    for name, module in (("student", state.student), ("disc", state.discriminator)):
        out.update({f"{name}.{k}": v.detach().clone() for k, v in module.state_dict().items()})
    for name, opt in (("g_opt", state.g_opt), ("d_opt", state.d_opt)):
        for i, st in opt.state_dict()["state"].items():
            out[f"{name}.{i}.momentum"] = st["momentum_buffer"].detach().clone()
    return out


def _compare_loop_states(start: dict, eager: dict, graph: dict, param_names: set) -> dict:
    """Per tensor, the relative L2 difference of graph against eager in the
    change over the chunk (graph − start against eager − start), for
    parameters, momenta, spectral u/v and running statistics alike; a tensor
    whose change is under 1e-4 of the largest change of its kind is held to
    that floor (phase 9's rule). Returns the worst of each kind and how many
    tensors are bit-equal."""
    check(sorted(eager) == sorted(graph) == sorted(start), "the runs' state keys differ")
    refs = {k: (eager[k] - start[k]).double() for k in eager}
    outs = {k: (graph[k] - start[k]).double() for k in graph}

    def kind(k: str) -> str:
        if k in param_names:
            return "param_update"
        if k.endswith("momentum"):
            return "momentum"
        if k.endswith(("weight_u", "weight_v")):
            return "spectral_uv"
        return "bn_stats"

    floors: dict = {}
    for k, r in refs.items():
        if r.is_floating_point():
            floors[kind(k)] = max(floors.get(kind(k), 0.0), UPDATE_FLOOR * r.norm().item())
    worst: dict = {}
    for k, r in refs.items():
        if not r.is_floating_point():
            check(torch.equal(r, outs[k]), f"eager vs graph {k} differs")
            continue
        nr, err = r.norm().item(), (outs[k] - r).norm().item()
        check(err <= max(LOOP_TENSOR_REL * nr, floors[kind(k)]),
              f"eager vs graph {k}: |diff| {err} vs |ref| {nr}")
        rel = err / nr if nr > 0 else 0.0
        worst[kind(k)] = max(worst.get(kind(k), (0.0, "")), (rel, k))
    bit_equal = sum(torch.equal(eager[k], graph[k]) for k in eager)
    return {"worst": worst, "bit_equal_tensors": bit_equal, "tensors": len(eager)}


def _timed_chunk(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0)


def _profiled_chunk(fn) -> dict:
    """One chunk under torch.profiler: wall ms, the union of the device's
    kernel and copy intervals over that wall (the `record_function` ranges,
    which the trace also puts on the device, left out), and the kernels
    counted by name."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    rows = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in STEP_RANGES]
    spans = sorted((e.time_range.start, e.time_range.end) for e in rows)
    busy_us, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    names = Counter(e.name for e in rows)
    counts = {k: sum(n for name, n in names.items()
                     if re.search(rf"(?<![A-Za-z0-9_]){kernel}(?![A-Za-z0-9_])", name))
              for k, kernel in GRAPH_KERNELS.items()}
    return {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
            "busy_share": busy_us / 1e3 / wall_ms, "device_rows": len(rows), "kernels": counts}


def _loop_variant(device: torch.device, bn_fused: bool, chunks: list) -> dict:
    """Warm-up and capture of one state's loop, then its chunks timed in
    turns with eager ones (`train_step` on the same state); the caller
    profiles later, after every unprofiled timing."""
    cfg = _train_config(unroll_steps=LOOP_UNROLL)
    state, gen = _full_state(cfg, device, bn_fused)
    loop = make_train_loop(cfg, cfg.unroll_steps)
    train_step = make_train_step(cfg)
    loop(state, *chunks[0], LOOP_UNROLL, gen)  # the eager warm-up chunk
    torch.cuda.reset_peak_memory_stats(device)
    capture_wall = _timed_chunk(lambda: loop(state, *chunks[1], LOOP_UNROLL, gen))
    check(loop.captures == 1 and loop.replays == 1, "the second chunk was not captured")
    peak_capture = torch.cuda.max_memory_allocated(device)

    def eager_chunk(chunk):
        return [train_step(state, chunk[0][i], chunk[1][i], gen) for i in range(LOOP_UNROLL)]

    def graph_chunk(chunk):
        return loop(state, *chunk, LOOP_UNROLL, gen)

    eager_ms, graph_ms, peaks = [], [], {}
    for turn in range(LOOP_TURNS):
        chunk = chunks[2 + turn % (len(chunks) - 2)]
        for label, fn, out in (("eager", eager_chunk, eager_ms), ("graph", graph_chunk, graph_ms)):
            torch.cuda.reset_peak_memory_stats(device)
            out.append(_timed_chunk(lambda: fn(chunk)) / LOOP_UNROLL)
            peaks[label] = max(peaks.get(label, 0), torch.cuda.max_memory_allocated(device))
    check(loop.replays == 1 + LOOP_TURNS and loop.eager_steps == LOOP_UNROLL,
          f"replays {loop.replays}, eager steps {loop.eager_steps}")
    return {"state": state, "gen": gen, "loop": loop, "eager_chunk": eager_chunk,
            "graph_chunk": graph_chunk, "chunk": chunks[2],
            "stats": {"eager_ms_per_step": eager_ms, "graph_ms_per_step": graph_ms,
                      "eager_images_per_second": [TRAIN_BATCH * 1e3 / t for t in eager_ms],
                      "graph_images_per_second": [TRAIN_BATCH * 1e3 / t for t in graph_ms],
                      "capture_ms": loop.capture_ms, "capture_chunk_wall_ms": capture_wall,
                      "max_memory_allocated": {"capture_and_replay": peak_capture, **peaks}}}


def _loop_equivalence(device: torch.device, chunks: list) -> dict:
    """From copies of one fused state after the loop's warm-up chunk: 4
    eager `train_step`s (recording every uniform they draw) and the loop's
    capture + one replay on the same chunk and generator state."""
    cfg = _train_config(unroll_steps=LOOP_UNROLL)
    state, gen = _full_state(cfg, device, bn_fused=True)
    loop = make_train_loop(cfg, cfg.unroll_steps)
    loop(state, *chunks[0], LOOP_UNROLL, gen)
    check(loop.eager_steps == LOOP_UNROLL and loop.graph is None, "the warm-up was not eager")
    ref = copy.deepcopy(state)
    ref_gen = torch.Generator().set_state(gen.get_state())
    start = _loop_state(state)
    params = {f"{n}.{k}" for n, m in (("student", state.student), ("disc", state.discriminator))
              for k, _ in m.named_parameters()}
    steps = range(state.step, state.step + LOOP_UNROLL)
    lrs = torch.tensor([state.g_sched(s) for s in steps] + [state.d_sched(s) for s in steps],
                       dtype=torch.float32)

    train_step = make_train_step(cfg)
    drawn, real_rand = [], torch.rand

    def recording_rand(*args, **kwargs):
        out = real_rand(*args, **kwargs)
        drawn.append(out.clone())
        return out

    torch.rand = recording_rand
    try:
        eager_m = [train_step(ref, chunks[1][0][i], chunks[1][1][i], ref_gen)
                   for i in range(LOOP_UNROLL)]
    finally:
        torch.rand = real_rand
    zero_counts()
    graph_m = loop(state, *chunks[1], LOOP_UNROLL, gen)
    torch.cuda.synchronize()
    capture_counts = read_counts()
    check(loop.captures == 1 and loop.replays == 1, "the chunk was not captured and replayed")

    scalars = loop.static_scalars.cpu()
    uniforms = torch.cat([d.reshape(-1) for d in drawn])
    check(torch.equal(scalars[:2 * LOOP_UNROLL], lrs), "the replay's lrs differ from the eager ones")
    check(torch.equal(scalars[2 * LOOP_UNROLL:], uniforms),
          "the replay's uniforms (masks, α) differ from the eager steps'")
    check(torch.equal(gen.get_state(), ref_gen.get_state()), "the generators differ after the chunk")
    # the masks and α the device computes from those uniforms
    plan = loop._plan
    masks_kept = []
    offset = 0
    for _ in range(LOOP_UNROLL):
        for shape in plan:
            n = math.prod(shape)
            if shape[1] > 1:  # a dropout mask, (N, C, 1, 1); α is (N, 1, 1, 1)
                masks_kept.append(int((uniforms[offset:offset + n] < 0.9).sum()))
            offset += n
    loss_rel = {}
    for i, em in enumerate(eager_m):
        for k, v in em.items():
            a, b = float(graph_m[k][i]), float(v)
            check(math.isfinite(a) and abs(a - b) <= STEP_LOSS_RTOL * abs(b) + STEP_LOSS_ATOL,
                  f"eager vs graph step {i} {k}: {b} vs {a}")
            loss_rel[k] = max(loss_rel.get(k, 0.0), abs(a - b) / max(abs(b), 1e-30))
    tensors = _compare_loop_states(start, _loop_state(ref), _loop_state(state), params)
    return {"uniforms": int(uniforms.numel()), "draws_per_step": [list(p) for p in plan],
            "dropout_channels_kept": masks_kept, "lrs": lrs.tolist(),
            "loss_max_rel_diff": loss_rel, **tensors,
            "capture_python_counts": {k: capture_counts[k] for k in GRAPH_KERNELS}}


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.records: list = []

    def emit(self, record: logging.LogRecord) -> None:
        self.records.append(record)


def _loop_cli(device: torch.device) -> dict:
    """`cli.train.main` with --unroll-steps 4 over 14 synthetic steps at full
    width: the eager first chunk, a capture and its replay, a replay and an
    eager tail of 2, with the profiler over steps [10, 15)."""
    trainer_log = logging.getLogger("structure_knowledge_distillation_tpu_torch.training.trainer")
    records = _Records()
    with tempfile.TemporaryDirectory(prefix="skd_loop_cli_") as work:
        prof_dir = os.path.join(work, "prof")
        argv = ["--data-set", "synthetic", "--unroll-steps", str(LOOP_UNROLL),
                "--num-steps", str(LOOP_CLI_STEPS), "--batch-size", str(TRAIN_BATCH),
                "--input-size", "%d,%d" % TRAIN_CROP, "--log-every", "1",
                "--device", device.type, "--profile-dir", prof_dir,
                "--log-path", os.path.join(work, "log"),
                "--snapshot-dir", os.path.join(work, "snap"), "--S_ckpt_path", ""]
        trainer_log.addHandler(records)
        try:
            zero_counts()
            t0 = time.perf_counter()
            train_cli.main(argv)
            took = time.perf_counter() - t0
            counts = read_counts()
        finally:
            trainer_log.removeHandler(records)
        rows = _scalars(os.path.join(work, "log"))
        steps = [r for r in rows if "g_loss" in r]
        check([r["step"] for r in steps] == list(range(1, LOOP_CLI_STEPS + 1)),
              f"the CLI logged steps {[r['step'] for r in steps]}")
        for r in steps:
            check(all(math.isfinite(v) for v in r.values()), f"a loss is not finite: {r}")
        evals = [r["step"] for r in rows if "val_mean_iu" in r]
        check(evals == [LOOP_CLI_STEPS - 1], f"the CLI evaluated at steps {evals}")
        summary = [r.args for r in records.records
                   if str(r.msg).startswith("multi-step loop:")]
        check(len(summary) == 1, "no multi-step loop summary logged")
        replayed, replays, captures, eager = summary[0]
        check((replayed, replays, captures, eager) == (8, 2, 1, 6),
              f"the CLI's loop replayed {replayed} steps in {replays} replays "
              f"({captures} captures), {eager} eager")
        traces = [os.path.join(prof_dir, n) for n in os.listdir(prof_dir)] if os.path.isdir(
            prof_dir) else []
        check(len(traces) == 1, f"profile_dir holds {traces}")
        with open(traces[0]) as f:
            check(GRAPH_KERNELS["K4"] in f.read(), "the trace does not name K4's kernel")
        trace_mb = os.path.getsize(traces[0]) / 1e6
    return {"seconds": took, "steps_logged": len(steps), "eval_steps": evals,
            "replayed_steps": replayed, "replays": replays, "eager_steps": eager,
            "python_counts": {k: counts[k] for k in ("K1", "K4", "K5")},
            "images_per_second": {r["step"]: r["img_per_sec"] for r in steps},
            "losses_last": {k: steps[-1][k] for k in ("g_loss", "d_loss", "mc_loss")},
            "trace_mb": trace_mb}


def phase_train_loop(device: torch.device, card: str) -> dict:
    """Phase 16: the multi-step loop (unroll 4) at full width: eager steps
    against a replay of the same chunk, eager and graph chunks timed in
    turns (fused and unfused), one profiled chunk of each, the launches of
    a replay counted from the trace, then the train CLI with
    --unroll-steps 4 --profile-dir."""
    cfg = _train_config()
    chunks = _device_chunks(cfg, 2 + LOOP_TURNS, device)
    equivalence = _loop_equivalence(device, chunks)
    torch.cuda.empty_cache()
    variants = {"fused": _loop_variant(device, True, chunks)}
    variants["unfused"] = _loop_variant(device, False, chunks)
    stats, per_replay = {}, None
    for name, v in variants.items():
        # profiled after every unprofiled timing: after a profiler window, later
        # unprofiled walls in the same process read slower
        eager_p = _profiled_chunk(lambda: v["eager_chunk"](v["chunk"]))
        graph_p = _profiled_chunk(lambda: v["graph_chunk"](v["chunk"]))
        # the profiler's own host cost stretches the eager wall; the device
        # time over the unprofiled median wall is the share without it
        for p, key in ((eager_p, "eager_ms_per_step"), (graph_p, "graph_ms_per_step")):
            wall = LOOP_UNROLL * statistics.median(v["stats"][key])
            p["busy_share_of_unprofiled_wall"] = p["device_busy_ms"] / wall
        stats[name] = {**v["stats"], "eager_profiled": eager_p, "graph_profiled": graph_p}
        if name == "fused":
            per_replay = graph_p["kernels"]
    n_teacher = _fused_abns(variants["fused"]["state"].teacher)
    n_student = _fused_abns(variants["fused"]["state"].student)
    expect = {"K4": LOOP_UNROLL, "K5": LOOP_UNROLL, "K6": (n_teacher + n_student) * LOOP_UNROLL,
              "K7": n_student * LOOP_UNROLL, "K8": n_student * LOOP_UNROLL}
    check(per_replay == expect, f"one fused replay launched {per_replay}, expected {expect}")
    unfused_replay = stats["unfused"]["graph_profiled"]["kernels"]
    check(unfused_replay == {**{k: 0 for k in expect}, "K4": LOOP_UNROLL, "K5": LOOP_UNROLL},
          f"one unfused replay launched {unfused_replay}")
    del variants
    torch.cuda.empty_cache()
    cli = _loop_cli(device)
    phase(16, "train_loop", card=card, unroll=LOOP_UNROLL,
          model="R101 teacher -> R18 student, full width, bf16 convs, batch 8, 512^2",
          equivalence=equivalence, launches_per_fused_replay=per_replay,
          tensor_rel_max=LOOP_TENSOR_REL, loss_rtol=STEP_LOSS_RTOL, loss_atol=STEP_LOSS_ATOL,
          **stats, cli=cli)
    return {"stats": stats, "equivalence": equivalence, "cli": cli}


def _sweep(run, warm=None) -> tuple:
    """(run()'s result, host ms, launch counts, peak bytes): `warm()` first
    (cuDNN's choices at new shapes), then every count set to 0 and the peak
    reset just before `run()`, read just after it has synchronised."""
    if warm is not None:
        warm()
    torch.cuda.synchronize()
    zero_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = run()
    torch.cuda.synchronize()
    return (out, 1e3 * (time.perf_counter() - t0), read_counts(),
            torch.cuda.max_memory_allocated())


def _class_maps(run, frames: list, device: torch.device) -> tuple:
    """A per-frame program (`make_*_val_fn`) over batch-1 val frames on the
    f32 wire: ([class map on the CPU], summed int64 confusion)."""
    maps, conf = [], np.zeros((NUM_CLASSES, NUM_CLASSES), np.int64)
    with torch.no_grad():
        for image, label, size, _ in frames:
            x = to_nchw(torch.from_numpy(image).to(device))
            lab = torch.from_numpy(label[0].astype(np.uint8)).to(device)
            pred, frame_conf = run(x, lab, int(size[0][0]), int(size[0][1]))
            maps.append(pred.cpu())
            conf += frame_conf.cpu().numpy()
    return maps, conf


def _frame_h2d(device: torch.device, image: np.ndarray) -> dict:
    """One eval frame host → device, CUDA events on the current stream: the
    pageable f32 copy the fast path made before, and the pinned copies of
    the f32 and the u8 wire that `evaluate_main` makes now; host ms of the
    quantization and the pinning beside (medians)."""
    current = torch.cuda.current_stream(device)
    f32 = torch.from_numpy(image)
    quantize_ms, u8 = _host_ms(lambda: torch.from_numpy(quantize_u8(image, IMG_MEAN_BGR)))
    pin_f32_ms, pinned_f32 = _host_ms(f32.pin_memory)
    pin_u8_ms, pinned_u8 = _host_ms(u8.pin_memory)
    return {"f32_bytes": f32.nbytes, "u8_bytes": u8.nbytes,
            "pageable_f32_ms": _copy_ms(lambda: f32.to(device), current),
            "pinned_f32_ms": _copy_ms(lambda: pinned_f32.to(device, non_blocking=True), current),
            "pinned_u8_ms": _copy_ms(lambda: pinned_u8.to(device, non_blocking=True), current),
            "host_quantize_ms": quantize_ms, "host_pin_f32_ms": pin_f32_ms,
            "host_pin_u8_ms": pin_u8_ms}


def _per_frame(ms: float, counts: dict, peak: int, n: int, **extra) -> dict:
    return {"ms_per_frame": ms / n, "frames": n, "max_memory_allocated": peak,
            "launches": {k: v for k, v in counts.items() if v}, **extra}


def _u8_train_wire(device: torch.device, root: str, val_list: str, work: str) -> dict:
    """Two uint8 chunks of LOOP_UNROLL batches (512² crops of the fake frames,
    random scale and mirror) through `make_train_loop` on phase 11's fused
    models, and the same chunks de-quantized on the host to bf16 through a
    second loop on a copy of the state: each loop an eager warm-up chunk,
    then a capture and its replay; every loss and state tensor must agree
    bit for bit."""
    cfg = _train_config(unroll_steps=LOOP_UNROLL)
    ds = CityscapesDataset(root, val_list, max_iters=2 * LOOP_UNROLL * TRAIN_BATCH,
                           crop_size=TRAIN_CROP, seed=0, cache_dir=os.path.join(work, "cache"))
    # the dataset repeats its records up to at least max_iters: take 2 full chunks
    host = list(cast_batches(chunk_batches(batch_iterator(ds, TRAIN_BATCH, seed=0), LOOP_UNROLL),
                             torch.uint8, torch.uint8, image_mean=IMG_MEAN_BGR))[:2]
    check(all(c.n_valid == LOOP_UNROLL for c in host), "a u8 chunk is not full")
    mean = torch.tensor(cfg.input_mean_bgr, dtype=torch.float32)
    wires = {"u8": [(to_nchw(c.images.to(device)), c.labels.to(device)) for c in host],
             "bf16": [(to_nchw((c.images.float() - mean).to(torch.bfloat16).to(device)),
                       c.labels.to(device)) for c in host]}
    state, gen = _full_state(cfg, device, bn_fused=True)
    runs = {"u8": (state, gen),
            "bf16": (copy.deepcopy(state), torch.Generator().set_state(gen.get_state()))}
    out, loops = {}, {}
    for wire, chunks in wires.items():
        st, g = runs[wire]
        loop = loops[wire] = make_train_loop(cfg, LOOP_UNROLL)
        metrics, ms, counts, peak = _sweep(lambda: [loop(st, *c, LOOP_UNROLL, g) for c in chunks])
        check(loop.eager_steps == LOOP_UNROLL and loop.captures == 1 and loop.replays == 1,
              f"the {wire} loop: {loop.eager_steps} eager steps, {loop.captures} captures, "
              f"{loop.replays} replays")
        check(loop._graph.images.dtype == chunks[0][0].dtype,
              f"the {wire} graph's static images are {loop._graph.images.dtype}")
        check(counts["K4"] >= 1 and counts["K5"] >= 1, f"the {wire} loop launched {counts}")
        out[wire] = {"metrics": metrics, "state": _loop_state(st),
                     "max_memory_allocated": peak, "captures": loop.captures,
                     "launches": {k: v for k, v in counts.items() if v}}
    for i, (mu, mb) in enumerate(zip(out["u8"]["metrics"], out["bf16"]["metrics"])):
        for k in mu:
            check(torch.equal(mu[k], mb[k]), f"chunk {i} {k}: u8 {mu[k].tolist()} vs "
                                             f"bf16 {mb[k].tolist()}")
    a, b = out["u8"].pop("state"), out["bf16"].pop("state")
    check(sorted(a) == sorted(b), "the two states' keys differ")
    unequal = [k for k in a if not torch.equal(a[k], b[k])]
    check(not unequal, f"u8 vs bf16 wire: {len(unequal)} tensors differ, first {unequal[:3]}")
    for wire in out:
        last = out[wire].pop("metrics")[-1]
        out[wire]["losses_last"] = {k: float(v[-1]) for k, v in last.items()}
        out[wire]["replay_ms_per_step"] = []
    # then more replays of the second chunk, in turns (u8, bf16, bf16, u8)
    for wire in ("u8", "bf16", "bf16", "u8"):
        st, g = runs[wire]
        ms = _timed_chunk(lambda: loops[wire](st, *wires[wire][1], LOOP_UNROLL, g))
        out[wire]["replay_ms_per_step"].append(ms / LOOP_UNROLL)
    check(all(lp.replays == 3 and lp.captures == 1 for lp in loops.values()),
          "a timed chunk was not a replay")
    return {"chunks": len(host), "bit_equal_tensors": len(a), **out}


def phase_eval_modes(device: torch.device) -> dict:
    """Phase 17: the inference modes beside the fast path, on phase 4's
    student (f32) and fake 1024×2048 Cityscapes frames; the u8 image wire
    in eval and in the multi-step train loop; `cli.test`'s submission."""
    model = _eval_student(device)
    with tempfile.TemporaryDirectory(prefix="skd_eval_modes_") as work:
        root = os.path.join(work, "cityscapes")
        write_fake_cityscapes(root, EM_FRAMES, seed=3)
        lists = make_cityscapes_lists(root, os.path.join(work, "list"))
        val = CityscapesDataset(root, lists["val"], crop_size=FULL_RES, scale=False, mirror=False)
        frames = list(batch_iterator(val, 1, shuffle=False, drop_last=False))
        n = len(frames)
        expect = sum(int((b[1] != 255).sum()) for b in frames)  # every frame is whole

        def sweep(**kw):
            return lambda fr=frames: evaluate_main(model, fr, NUM_CLASSES, out_size=FULL_RES,
                                                   device=device, **kw)

        # 1. the fast path on both wires
        parts = {}
        (f32_miou, _, f32_conf), ms, counts, peak = _sweep(sweep(),
                                                           warm=lambda: sweep()(frames[:1]))
        parts["fast_f32"] = _per_frame(ms, counts, peak, n, miou=f32_miou)
        (u8_miou, _, u8_conf), ms, counts, peak = _sweep(sweep(input_mean=IMG_MEAN_BGR))
        parts["fast_u8"] = _per_frame(ms, counts, peak, n, miou=u8_miou)
        check(np.array_equal(u8_conf, f32_conf), "the u8 wire's confusion differs from the f32's")
        check(int(f32_conf.sum()) == expect, f"the fast path counted {int(f32_conf.sum())} pixels")
        k1 = [parts[p]["launches"].get("K1") for p in ("fast_f32", "fast_u8")]
        check(k1 == [n, n], f"K1 launched {k1} times on the two wires over {n} frames")
        parts["fast_u8"]["h2d"] = _frame_h2d(device, frames[0][0])

        # 2. multiscale + flip; one scale without flip against the fast path
        (msf_miou, _, msf_conf), ms, counts, peak = _sweep(
            sweep(scales=EM_SCALES, flip=True, input_mean=IMG_MEAN_BGR),
            warm=lambda: sweep(scales=EM_SCALES, flip=True)(frames[:1]))
        parts["msf"] = _per_frame(ms, counts, peak, n, scales=list(EM_SCALES), flip=True,
                                  miou=msf_miou)
        check(int(msf_conf.sum()) == expect, f"msf counted {int(msf_conf.sum())} pixels")
        fast_maps, fast_conf = _class_maps(make_fast_val_fn(model, FULL_RES, NUM_CLASSES),
                                           frames, device)
        one_maps, one_conf = _class_maps(
            make_msf_val_fn(model, FULL_RES, NUM_CLASSES, (1.0,), False), frames, device)
        agree = float(np.mean([(a == b).float().mean().item()
                               for a, b in zip(fast_maps, one_maps)]))
        one_gap = abs(iu_from_confusion(one_conf)[0] - iu_from_confusion(fast_conf)[0])
        check(agree >= CLASS_MAP_AGREEMENT_MIN, f"msf (1.0,) vs fast class maps agree in {agree}")
        check(one_gap <= EVAL_MIOU_ATOL, f"msf (1.0,) vs fast mIoU differ by {one_gap}")
        parts["msf"].update(one_scale_vs_fast_agreement=agree, one_scale_vs_fast_miou_gap=one_gap)

        # 3. sliding tiles; one whole-frame tile against msf at (1.0,)
        tiles = len(list(_tile_grid(FULL_RES, EM_TILE, 1.0 / 3.0)))
        (sl_miou, _, sl_conf), ms, counts, peak = _sweep(
            sweep(whole=False, tile_size=EM_TILE, input_mean=IMG_MEAN_BGR),
            warm=lambda: sweep(whole=False, tile_size=EM_TILE)(frames[:1]))
        parts["sliding"] = _per_frame(ms, counts, peak, n, tile=list(EM_TILE),
                                      tiles_per_frame=tiles, miou=sl_miou)
        check(int(sl_conf.sum()) == expect, f"sliding counted {int(sl_conf.sum())} pixels")
        whole_maps, _ = _class_maps(make_sliding_val_fn(model, FULL_RES, FULL_RES, NUM_CLASSES),
                                    frames, device)
        check(all(torch.equal(a, b) for a, b in zip(whole_maps, one_maps)),
              "one whole-frame tile's class maps differ from msf at (1.0,)")

        # 4. batched groups: 8 + a tail of 1 with 7 masked slots; one msf group
        def sharded(fr=frames, **kw):
            return evaluate_sharded(model, fr, NUM_CLASSES, out_size=FULL_RES, batch=K1_GROUP,
                                    input_mean=IMG_MEAN_BGR, device=device, **kw)

        (sh_miou, _, sh_conf), ms, counts, peak = _sweep(sharded, warm=lambda: sharded(frames[:1]))
        parts["sharded"] = _per_frame(ms, counts, peak, n, batch=K1_GROUP, miou=sh_miou,
                                      miou_gap=abs(sh_miou - f32_miou))
        check(int(sh_conf.sum()) == expect, f"the groups counted {int(sh_conf.sum())} pixels")
        check(abs(sh_miou - f32_miou) <= EVAL_MIOU_ATOL, f"groups {sh_miou} vs frames {f32_miou}")
        check(counts["K1"] == 2, f"K1 launched {counts['K1']} times for two groups")
        group = frames[:K1_GROUP]
        (shm_miou, _, shm_conf), ms, counts, peak = _sweep(
            lambda: sharded(group, scales=EM_SCALES, flip=True),
            warm=lambda: sharded(group[:1], scales=EM_SCALES, flip=True))
        msf_group_miou, _, _ = sweep(scales=EM_SCALES, flip=True)(group)
        parts["sharded_msf"] = _per_frame(ms, counts, peak, len(group), batch=K1_GROUP,
                                          miou=shm_miou, miou_gap=abs(shm_miou - msf_group_miou))
        check(int(shm_conf.sum()) == sum(int((b[1] != 255).sum()) for b in group),
              f"the msf group counted {int(shm_conf.sum())} pixels")
        check(abs(shm_miou - msf_group_miou) <= EVAL_MIOU_ATOL,
              f"msf group {shm_miou} vs frames {msf_group_miou}")

        # 5. the test-server submission
        out_dir = os.path.join(work, "submission")
        argv = ["--data-dir", root, "--data-list", lists["test"], "--output-dir", out_dir,
                "--device", device.type]
        with contextlib.redirect_stdout(io.StringIO()):  # the CLI prints its config
            _, ms, counts, peak = _sweep(lambda: test_cli.main(argv))
        pngs = sorted(os.listdir(out_dir))
        label_ids = set(trainid2id(np.arange(NUM_CLASSES, dtype=np.uint8)).tolist())
        check(len(pngs) == dict(EM_FRAMES)["test"], f"cli.test wrote {pngs}")
        for name in pngs:
            with Image.open(os.path.join(out_dir, name)) as im:
                png = np.asarray(im)
                check(im.mode == "P" and png.shape == FULL_RES, f"{name}: {im.mode} {png.shape}")
            check(set(np.unique(png).tolist()) <= label_ids, f"{name} holds non-labelIds")
        parts["cli_test"] = _per_frame(ms, counts, peak, len(pngs), pngs=pngs,
                                       note="model build and PNG writes included")

        # 6. the u8 train wire in the multi-step loop
        parts["u8_train_loop"] = _u8_train_wire(device, root, lists["val"], work)
    for name, fields in parts.items():
        phase(17, f"eval_modes/{name}", **fields)
    return parts


# phase 18: the CamVid ESPNet-C distillation recipe (scripts/run_camvid_espnet.sh)
# at full width: R101 teacher and ESPNet-C (p=2, q=8) student at 11 classes,
# batch 8, 360×480 crops, bf16, Pi+Pa, ho false; the student's heads are
# stride 8 (45×60) and stride 4 (90×120), so the DSN CE is K2/K3 twice a step
CV_CLASSES = 11
CV_CROP = (360, 480)
CV_IMSIZE_ADV = 46
CV_HEADS = ((TRAIN_BATCH, CV_CLASSES, 45, 60), (TRAIN_BATCH, CV_CLASSES, 90, 120))
CV_FRAMES = (("train", 8), ("val", 3))
CV_CLI_STEPS = 8  # two chunks of 4: the eager warm-up, then a capture and its replay
# OHEM at the R18 recipe: k = 100000 // 64 = 1562 < the 1/8 grid's 8·64·64
OHEM_MIN_KEPT = 100000
OHEM_LOSS_RTOL = 1e-4  # CPU and card softmax/resize round differently; the kept set may differ by a pixel
OHEM_THRESH_ATOL = 1e-6
# VOC at its eval size: 505×505 frames (R18 logits 64×64), 21 classes
VOC_CLASSES = 21
VOC_FRAMES = (("val", 4), ("test", 2))
VOC_SIZE = (375, 500)  # a typical VOC frame, padded to 505×505 by the loaders


def _camvid_config(**overrides) -> TrainConfig:
    kw = dict(classes_num=CV_CLASSES, input_size=CV_CROP, imsize_for_adv=CV_IMSIZE_ADV,
              student_arch="espnet", pi=True, pa=True, ho=False, unroll_steps=LOOP_UNROLL)
    kw.update(overrides)
    return _train_config(**kw)


def _camvid_state(cfg, device: torch.device) -> tuple:
    """The recipe's models: the R101 teacher (11 classes) from seed 2 with
    random running statistics, the ESPNet-C student and D drawn from a
    generator seeded as `KDTrainer` seeds it; returns (state, generator)."""
    dtype = torch.bfloat16
    teacher = ResPSPNet(BOTTLENECK, tuple(cfg.teacher_layers), CV_CLASSES, device=device,
                        generator=torch.Generator().manual_seed(2), dtype=dtype)
    randomize_bn_stats(teacher, 3)
    teacher.requires_grad_(False)
    gen = torch.Generator().manual_seed(cfg.seed)
    student = ESPNetC(CV_CLASSES, device=device, dtype=dtype, generator=gen)
    disc = Discriminator(CV_CLASSES, preprocess_mode=cfg.preprocess_gan_mode,
                         image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim, dtype=dtype,
                         device=device, generator=gen)
    state = KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    return state, gen


def _eager_vs_replay(state, gen, cfg, chunks) -> tuple:
    """After the loop's eager warm-up chunk (chunks[0]), a copy of the state
    takes the next chunk's steps eagerly through `train_step` while the loop
    captures and replays it (phase 16's equivalence): losses within phase 9's
    rtol/atol, every tensor within LOOP_TENSOR_REL in its change. Returns
    (loop, reference state and generator, the eager steps' ms, their launch
    counts over the first step and over all, the comparison)."""
    unroll = chunks[0][0].shape[0]
    loop = make_train_loop(cfg, unroll)
    loop(state, *chunks[0], unroll, gen)
    check(loop.eager_steps == unroll and loop.graph is None, "the warm-up chunk was not eager")
    # the capture makes both optimizers' momentum buffers (D's stay zero
    # when ho is false): make them first, so the three states hold one set
    for module, opt in ((state.student, state.g_opt), (state.discriminator, state.d_opt)):
        momentum_buffers(opt, [p for p in module.parameters() if p.requires_grad])
    ref = copy.deepcopy(state)
    ref_gen = torch.Generator().set_state(gen.get_state())
    start = _loop_state(state)
    params = {f"{n}.{k}" for n, m in (("student", state.student), ("disc", state.discriminator))
              for k, _ in m.named_parameters()}
    train_step = make_train_step(cfg)
    torch.cuda.synchronize()
    zero_counts()
    t0 = time.perf_counter()
    eager_m = [train_step(ref, chunks[1][0][0], chunks[1][1][0], ref_gen)]
    torch.cuda.synchronize()
    first = read_counts()
    eager_m += [train_step(ref, chunks[1][0][i], chunks[1][1][i], ref_gen)
                for i in range(1, unroll)]
    torch.cuda.synchronize()
    eager_ms = 1e3 * (time.perf_counter() - t0) / unroll
    counts = read_counts()
    graph_m = loop(state, *chunks[1], unroll, gen)
    torch.cuda.synchronize()
    check(loop.captures == 1 and loop.replays == 1, "the chunk was not captured and replayed")
    check(torch.equal(gen.get_state(), ref_gen.get_state()), "the generators differ after the chunk")
    loss_rel = {}
    for i, em in enumerate(eager_m):
        for k, v in em.items():
            a, b = float(graph_m[k][i]), float(v)
            check(math.isfinite(a) and abs(a - b) <= STEP_LOSS_RTOL * abs(b) + STEP_LOSS_ATOL,
                  f"eager vs graph step {i} {k}: {b} vs {a}")
            loss_rel[k] = max(loss_rel.get(k, 0.0), abs(a - b) / max(abs(b), 1e-30))
    tensors = _compare_loop_states(start, _loop_state(ref), _loop_state(state), params)
    return loop, ref, ref_gen, eager_ms, first, counts, {"loss_max_rel_diff": loss_rel,
                                                         **tensors}


def _camvid_step(device: torch.device) -> dict:
    """Part 1: the CamVid step at full width, eager and as a replay."""
    cfg = _camvid_config()
    state, gen = _camvid_state(cfg, device)
    chunks = _device_chunks(cfg, 3, device, seed=7)
    torch.cuda.reset_peak_memory_stats(device)
    loop, ref, ref_gen, eager_ms, first, counts, equivalence = _eager_vs_replay(
        state, gen, cfg, chunks)
    check((first["K2"], first["K3"], first["K4"], first["K5"]) == (2, 2, 0, 0),
          f"one CamVid step launched K2/K3/K4/K5 {first['K2']}/{first['K3']}/{first['K4']}/"
          f"{first['K5']} times, expected 2/2/0/0")
    check(counts["K2"] == counts["K3"] == 2 * LOOP_UNROLL,
          f"{LOOP_UNROLL} eager CamVid steps launched K2/K3 {counts['K2']}/{counts['K3']} times")
    check(loop._plan == [], f"a CamVid step drew uniforms: {loop._plan}")
    replay_ms = [_timed_chunk(lambda: loop(state, *chunks[2], LOOP_UNROLL, gen)) / LOOP_UNROLL
                 for _ in range(2)]
    check(loop.replays == 3, "a timed chunk was not a replay")
    peak = torch.cuda.max_memory_allocated(device)
    # one eager step with the adversarial term on: D (image_size 46) on the
    # student's 45×60 logits and the resized teacher's, the GP included
    ho_cfg = _camvid_config(ho=True)
    ho = make_train_step(ho_cfg)(ref, chunks[2][0][0], chunks[2][1][0], ref_gen)
    torch.cuda.synchronize()
    ho_losses = {k: float(v) for k, v in ho.items()}
    check(all(math.isfinite(v) for v in ho_losses.values()), f"the ho step: {ho_losses}")
    check(ho_losses["d_loss"] != 0.0 and "adv_g_loss" in ho_losses, f"the ho step: {ho_losses}")
    return {"eager_ms_per_step": eager_ms, "replay_ms_per_step": replay_ms,
            "eager_images_per_second": TRAIN_BATCH * 1e3 / eager_ms,
            "replay_images_per_second": [TRAIN_BATCH * 1e3 / t for t in replay_ms],
            "capture_ms": loop.capture_ms,
            "max_memory_allocated_two_states": peak,
            "launches_per_step": {k: first[k] for k in ("K2", "K3", "K4", "K5")},
            "launches": counts, "equivalence": equivalence, "ho_step_losses": ho_losses}


def _camvid_ce_kernels(device: torch.device) -> dict:
    """Part 2: K2/K3 at the two CamVid head shapes against their plain
    versions, bf16 logits and int32 labels (5 % ignored), as phase 7 holds
    them at the R18 shape; per head and summed over the two heads of a step."""
    g = torch.Generator(device=device).manual_seed(21)
    labels = torch.randint(0, CV_CLASSES, (TRAIN_BATCH, *CV_CROP), generator=g, device=device,
                           dtype=torch.int32)
    labels[torch.rand(labels.shape, generator=g, device=device) < 0.05] = 255
    heads, total = [], {"fwd": {}, "bwd": {}}
    for shape in CV_HEADS:
        x = (2.0 * torch.randn(shape, generator=g, device=device)).to(torch.bfloat16)
        x.requires_grad_(True)
        runs = []
        for _ in range(2):
            loss = upsampled_ce_loss(x, labels, CV_CROP)
            runs.append((loss.detach(), torch.autograd.grad(loss, x)[0]))
        ref = upsampled_ce_loss_plain(x, labels, CV_CROP)
        ref_grad = torch.autograd.grad(ref, x)[0]
        torch.cuda.synchronize()
        (loss, grad), (loss2, grad2) = runs
        name = f"{tuple(shape)}->{CV_CROP}"
        check(torch.equal(loss, loss2) and torch.equal(grad, grad2), f"{name}: two runs differ")
        loss_err = abs(loss.item() - ref.item())
        check(loss_err <= CE_LOSS_RTOL * abs(ref.item()) + 1e-7,
              f"K2 {name}: loss {loss.item()} vs plain {ref.item()}")
        grad_err = (grad.float() - ref_grad.float()).abs().max().item()
        grad_max = ref_grad.float().abs().max().item()
        check(grad_err <= CE_GRAD_REL[torch.bfloat16] * grad_max + 1e-12,
              f"K3 {name}: grad max |diff| {grad_err} vs max |grad| {grad_max}")
        fwd_ms = cuda_median_ms(lambda: upsampled_ce_loss(x, labels, CV_CROP))
        plain_fwd_ms = cuda_median_ms(lambda: upsampled_ce_loss_plain(x, labels, CV_CROP))
        loss = upsampled_ce_loss(x, labels, CV_CROP)
        ref = upsampled_ce_loss_plain(x, labels, CV_CROP)
        bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(loss, x, retain_graph=True))
        plain_bwd_ms = cuda_median_ms(lambda: torch.autograd.grad(ref, x, retain_graph=True))
        # phase 7's count: the separable resize of every class, the
        # log-softmax per labelled pixel and class; the backward twice the
        # resize and softmax − one-hot
        n, c, h_in, w_in = shape
        valid = int((labels != 255).sum())
        resize = 3 * n * c * CV_CROP[0] * (w_in + CV_CROP[1])
        fwd = {"max_abs_err": loss_err, "ms": fwd_ms, "plain_ms": plain_fwd_ms,
               **card_bound(x.nbytes + labels.numel() * 4 + 4, resize + 3 * c * valid)}
        bwd = {"max_abs_err": grad_err, "ms": bwd_ms, "plain_ms": plain_bwd_ms,
               **card_bound(2 * x.nbytes + labels.numel() * 4, 2 * resize + 5 * c * valid)}
        heads.append({"shape": list(shape), "out": list(CV_CROP), "loss": loss.item(),
                      "K2": fwd, "K3": bwd, "grad_max": grad_max})
        for key, rec in (("fwd", fwd), ("bwd", bwd)):
            t = total[key]
            for f in ("ms", "plain_ms", "bound_ms"):
                t[f] = t.get(f, 0.0) + rec[f]
            t["max_abs_err"] = max(t.get("max_abs_err", 0.0), rec["max_abs_err"])
    record = {}
    for k, key in (("K2", "fwd"), ("K3", "bwd")):
        t = total[key]
        record[k] = {"max_abs_err": t["max_abs_err"], "ms": t["ms"], "plain_ms": t["plain_ms"],
                     "bound_ms": t["bound_ms"],
                     "bound_by": ("bytes" if all(h[k]["bound_by"] == "bytes" for h in heads)
                                  else "operations"),
                     "library_ms": None, "bound_share": t["bound_ms"] / t["ms"],
                     "shapes": "per CamVid step: the two heads' calls summed",
                     "per_head": [{"shape": h["shape"], **h[k]} for h in heads]}
    return {"heads": heads, "record": record}


def _ohem_part(device: torch.device) -> dict:
    """Part 4: an R18 step at the reference recipe with `ohem` (min_kept
    100000: k = 1562), eagerly and as a replay (TrainLoop of one step: its
    warm-up step, then a capture), and `criterion_ohem_dsn` on the card
    against the CPU on confident logits (a kept set below every pixel)."""
    cfg = _train_config(ohem=True, ohem_min_kept=OHEM_MIN_KEPT, unroll_steps=1)
    state, gen = _full_state(cfg, device, bn_fused=False)
    images, labels = _device_chunks(cfg, 1, device)[0]
    chunks = [(images[i:i + 1], labels[i:i + 1]) for i in range(2)]
    loop, ref, _, eager_ms, first, _, equivalence = _eager_vs_replay(state, gen, cfg, chunks)
    check(first["K4"] == 0 and first["K2"] == 0, f"the OHEM step launched the CE kernels {first}")
    replay_ms = _timed_chunk(lambda: loop(state, *chunks[1], 1, gen))
    # the criterion alone, card vs CPU, on the logits of a confident model:
    # classes in blocks of 8×8 low-res pixels, the label's logit 10 above
    # N(0, 1) noise, labels the align-corners nearest samples of the blocks
    # (5 % ignored); then the k-th smallest probability sets the threshold
    g = torch.Generator().manual_seed(22)
    low = torch.randint(0, NUM_CLASSES, (TRAIN_BATCH, 9, 9), generator=g)
    low = low.repeat_interleave(8, 1).repeat_interleave(8, 2)[:, :65, :65]
    idx = torch.floor(torch.arange(TRAIN_CROP[0]) * (64 / (TRAIN_CROP[0] - 1)) + 0.5).long()
    full = low[:, idx][:, :, idx].clone()
    full[torch.rand(full.shape, generator=g) < 0.05] = 255
    onehot = F.one_hot(low, NUM_CLASSES).permute(0, 3, 1, 2).float()
    preds = (10.0 * onehot + torch.randn(onehot.shape, generator=g),
             torch.randn(onehot.shape, generator=g))
    out = {}
    for dev in ("cpu", device):
        p = tuple(t.to(dev) for t in preds)
        lab = full.to(dev)
        up = resize_bilinear_align_corners(p[0], TRAIN_CROP)
        out[str(dev)] = (float(criterion_ohem_dsn(p, lab, 255, 0.7, OHEM_MIN_KEPT)),
                         float(ohem_threshold(up, lab, 255, 0.7, OHEM_MIN_KEPT)))
    (l_cpu, t_cpu), (l_gpu, t_gpu) = out["cpu"], out[str(device)]
    check(abs(l_gpu - l_cpu) <= OHEM_LOSS_RTOL * abs(l_cpu), f"OHEM loss card {l_gpu} vs CPU {l_cpu}")
    check(abs(t_gpu - t_cpu) <= OHEM_THRESH_ATOL, f"OHEM threshold card {t_gpu} vs CPU {t_cpu}")
    check(0.7 < t_gpu < 1.0, f"the OHEM threshold {t_gpu} did not come from the k-th probability")
    return {"k": OHEM_MIN_KEPT // 64, "eager_ms_per_step": eager_ms, "replay_ms": replay_ms,
            "equivalence": equivalence, "criterion": {"loss_card": l_gpu, "loss_cpu": l_cpu,
                                                      "threshold_card": t_gpu,
                                                      "threshold_cpu": t_cpu}}


def _interval_peaks(state, run, device: torch.device) -> list:
    """`run()` (one step on `state`) with the peak and the allocated bytes at
    the end of each interval between the forwards of the teacher, the
    student and every application of D, read by forward hooks (each one
    synchronises, so the step is not timed here)."""
    marks = []

    def mark(end: str) -> None:
        torch.cuda.synchronize()
        marks.append({"end": end, "peak": torch.cuda.max_memory_allocated(device),
                      "allocated": torch.cuda.memory_allocated(device)})
        torch.cuda.reset_peak_memory_stats(device)

    hooks = []
    for name, module in (("teacher", state.teacher), ("student", state.student),
                         ("D", state.discriminator)):
        hooks.append(module.register_forward_pre_hook(lambda m, a, n=name: mark(f"before {n}")))
        hooks.append(module.register_forward_hook(lambda m, a, o, n=name: mark(f"after {n}")))
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        run()
        mark("end of step")
    finally:
        for h in hooks:
            h.remove()
    return marks


def _remat_part(device: torch.device) -> dict:
    """Part 5: one R18 step at the reference recipe with and without
    `remat`, from copies of one state and generator: losses within phase 9's
    rtol/atol, every tensor (running statistics included) within
    LOOP_TENSOR_REL in its change over the step, so statistics moved twice
    would fail; ms and peak memory of each (the memory the recompute saves)."""
    cfg = _train_config()
    state, gen = _full_state(cfg, device, bn_fused=False)
    (images, labels), = _device_chunks(cfg, 1, device)
    train_step = make_train_step(cfg)
    train_step(state, images[0], labels[0], gen)  # warm-up: cuDNN's choices, momentum buffers
    torch.cuda.synchronize()
    start = _loop_state(state)
    params = {f"{n}.{k}" for n, m in (("student", state.student), ("disc", state.discriminator))
              for k, _ in m.named_parameters()}
    runs = {}
    for remat in (False, True, False, True):  # warm, then timed, each
        st = copy.deepcopy(state)
        st.student.remat = remat
        g = torch.Generator().set_state(gen.get_state())
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(device)
        t0 = time.perf_counter()
        m = train_step(st, images[1], labels[1], g)
        torch.cuda.synchronize()
        runs[remat] = {"ms": 1e3 * (time.perf_counter() - t0),
                       "max_memory_allocated": torch.cuda.max_memory_allocated(device),
                       "metrics": {k: float(v) for k, v in m.items()}, "state": _loop_state(st)}
        del st
    # where the memory goes, on copies, one step each: the peak of every
    # interval between module forwards (teacher, student, each application
    # of D), and what the student's forward holds for its backward
    for flag in (False, True):
        st = copy.deepcopy(state)
        st.student.remat = flag
        marks = _interval_peaks(st, lambda: train_step(st, images[1], labels[1],
                                                       torch.Generator().set_state(
                                                           gen.get_state())), device)
        after = [m for m in marks if m["end"] == "after student"][0]
        before = [m for m in marks if m["end"] == "before student"][0]
        runs[flag]["student_forward_held_bytes"] = after["allocated"] - before["allocated"]
        runs[flag]["interval_peaks"] = marks
        del st
    plain, remat = runs[False], runs[True]
    for k, b in plain["metrics"].items():
        a = remat["metrics"][k]
        check(math.isfinite(a) and abs(a - b) <= STEP_LOSS_RTOL * abs(b) + STEP_LOSS_ATOL,
              f"remat vs plain {k}: {a} vs {b}")
    tensors = _compare_loop_states(start, plain["state"], remat["state"], params)
    # moved once: the student's running statistics change by what the plain
    # step's change (a second update in the recompute would add 90 % to it)
    stats = [k for k in start if k.startswith("student.") and k.endswith("running_mean")]
    change = {name: torch.cat([(run["state"][k] - start[k]).double().reshape(-1)
                               for k in stats]).norm().item() for name, run in runs.items()}
    ratio = change[True] / change[False]
    check(abs(ratio - 1.0) <= LOOP_TENSOR_REL,
          f"remat moved the running means by {ratio} of the plain step's change")
    keys = ("ms", "max_memory_allocated", "student_forward_held_bytes", "interval_peaks")
    return {"plain": {k: plain[k] for k in keys}, "remat": {k: remat[k] for k in keys},
            "peak_saved": plain["max_memory_allocated"] - remat["max_memory_allocated"],
            "held_saved": plain["student_forward_held_bytes"] - remat["student_forward_held_bytes"],
            "running_mean_change_ratio": ratio, "equivalence": tensors,
            "losses": remat["metrics"]}


def _blocky(rng, high: int, size) -> np.ndarray:
    small = rng.integers(0, high, (-(-size[0] // 15), -(-size[1] // 15)))
    return small.repeat(15, 0).repeat(15, 1)[:size[0], :size[1]].astype(np.uint8)


def write_fake_camvid(root: str, frames=CV_FRAMES, size=CV_CROP, seed: int = 0) -> None:
    """The SegNet-style CamVid tree from a seed: `{split}/*.png` BGR frames
    (phase 15's smooth field under noise) and `{split}annot/*.png` labels
    0..11 in blocks, 11 the void class."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w = size
    for split, n in frames:
        for sub in (split, split + "annot"):
            os.makedirs(os.path.join(root, sub), exist_ok=True)
        for i in range(n):
            field = rng.uniform(0, 255, (7, 9, 3)).astype(np.float32)
            image = cv2.resize(field, (w, h), interpolation=cv2.INTER_CUBIC)
            image += rng.normal(0.0, 12.0, image.shape).astype(np.float32)
            name = f"{split}_{i:04d}.png"
            check(cv2.imwrite(os.path.join(root, split, name),
                              np.clip(image, 0, 255).astype(np.uint8)), "cv2.imwrite failed")
            check(cv2.imwrite(os.path.join(root, split + "annot", name),
                              _blocky(rng, CV_CLASSES + 1, size)), "cv2.imwrite failed")


def write_fake_voc(root: str, frames=VOC_FRAMES, size=VOC_SIZE, seed: int = 0) -> None:
    """A VOC tree from a seed: `ImageSets/Segmentation/{split}.txt`,
    `JPEGImages/<id>.jpg` and `SegmentationClassAug/<id>.png` (class ids
    0..20 in blocks, a 255 border; none for test)."""
    import cv2

    rng = np.random.default_rng(seed)
    sets = os.path.join(root, "ImageSets", "Segmentation")
    for d in (sets, os.path.join(root, "JPEGImages"), os.path.join(root, "SegmentationClassAug")):
        os.makedirs(d, exist_ok=True)
    for split, n in frames:
        ids = [f"2008_{split}_{i:04d}" for i in range(n)]
        with open(os.path.join(sets, f"{split}.txt"), "w") as f:
            f.writelines(i + "\n" for i in ids)
        for i in ids:
            check(cv2.imwrite(os.path.join(root, "JPEGImages", f"{i}.jpg"),
                              rng.integers(0, 256, (*size, 3), dtype=np.uint8)), "imwrite failed")
            if split != "test":
                label = _blocky(rng, VOC_CLASSES, size)
                label[:3] = 255
                check(cv2.imwrite(os.path.join(root, "SegmentationClassAug", f"{i}.png"), label),
                      "imwrite failed")


def _item7_clis(device: torch.device) -> dict:
    """Part 6: `cli.train` on a fake CamVid tree with the recipe's flags and
    --unroll-steps 4 (an eager chunk, a capture and its replay, the eval at
    360×480 with K1 counted), `cli.eval` and `cli.test` on a fake VOC tree
    with the R18 student at 21 classes (505×505), and the CamVid u8 eval wire
    against the f32 one."""
    trainer_log = logging.getLogger("structure_knowledge_distillation_tpu_torch.training.trainer")
    records = _Records()
    out = {}
    with tempfile.TemporaryDirectory(prefix="skd_item7_") as work:
        cv_root, voc_root = os.path.join(work, "camvid"), os.path.join(work, "voc")
        write_fake_camvid(cv_root, seed=8)
        write_fake_voc(voc_root, seed=9)
        argv = ["--data-set", "camvid", "--data-dir", cv_root,
                "--data-list", os.path.join(work, "list", "camvid", "train.lst"),
                "--val-data-list", os.path.join(work, "list", "camvid", "val.lst"),
                "--student-arch", "espnet", "--classes_num", str(CV_CLASSES),
                "--input-size", "%d,%d" % CV_CROP, "--imsize-for-adv", str(CV_IMSIZE_ADV),
                "--random-mirror", "--random-scale", "--batch-size", str(TRAIN_BATCH),
                "--pi", "true", "--pa", "true", "--ho", "false",
                "--num-steps", str(CV_CLI_STEPS), "--unroll-steps", str(LOOP_UNROLL),
                "--log-every", "1", "--device", device.type,
                "--log-path", os.path.join(work, "log"),
                "--snapshot-dir", os.path.join(work, "snap"), "--S_ckpt_path", ""]
        trainer_log.addHandler(records)
        try:
            _, ms, counts, peak = _sweep(lambda: train_cli.main(argv))
        finally:
            trainer_log.removeHandler(records)
        rows = _scalars(os.path.join(work, "log"))
        steps = [r for r in rows if "g_loss" in r]
        check([r["step"] for r in steps] == list(range(1, CV_CLI_STEPS + 1)),
              f"the CamVid CLI logged steps {[r['step'] for r in steps]}")
        for r in steps:
            check(all(math.isfinite(v) for v in r.values()), f"a loss is not finite: {r}")
        evals = [r["step"] for r in rows if "val_mean_iu" in r]
        check(evals == [CV_CLI_STEPS - 1], f"the CamVid CLI evaluated at steps {evals}")
        summary = [r.args for r in records.records if str(r.msg).startswith("multi-step loop:")]
        check(len(summary) == 1 and summary[0] == (LOOP_UNROLL, 1, 1, LOOP_UNROLL),
              f"the CamVid CLI's loop: {summary}")
        n_val = dict(CV_FRAMES)["val"]
        check(counts["K1"] == n_val, f"the CamVid eval launched K1 {counts['K1']} times")
        # Python counts: the eager chunk's steps and the captured ones, 2 a step
        check(counts["K2"] == counts["K3"] == 2 * 2 * LOOP_UNROLL and counts["K4"] == 0,
              f"the CamVid CLI launched {counts}")
        out["cli_train_camvid"] = {"seconds": ms / 1e3, "max_memory_allocated": peak,
                                   "launches": {k: v for k, v in counts.items() if v},
                                   "val_mean_iu": [r["val_mean_iu"] for r in rows
                                                   if "val_mean_iu" in r],
                                   "images_per_second": {r["step"]: r["img_per_sec"]
                                                         for r in steps},
                                   "losses_last": {k: steps[-1][k] for k in
                                                   ("g_loss", "mc_loss", "pi_loss", "pa_loss")}}

        # the CamVid u8 eval wire against the f32 one, ESPNet-C in f32
        val = CamVidDataset(cv_root, os.path.join(work, "list", "camvid", "val.lst"),
                            crop_size=CV_CROP, scale=False, mirror=False)
        frames = list(batch_iterator(val, 1, shuffle=False, drop_last=False))
        model = ESPNetC(CV_CLASSES, device=device, generator=torch.Generator().manual_seed(6))
        model.eval()
        sweep = lambda mean: evaluate_main(model, frames, CV_CLASSES, out_size=CV_CROP,  # noqa
                                           input_mean=mean, device=device)
        (f32_miou, _, f32_conf), ms_f32, c_f32, _ = _sweep(lambda: sweep(None),
                                                           warm=lambda: sweep(None))
        (u8_miou, _, u8_conf), ms_u8, c_u8, _ = _sweep(lambda: sweep(CAMVID_MEAN))
        check(np.array_equal(u8_conf, f32_conf), "the CamVid u8 wire's confusion differs")
        check(c_f32["K1"] == c_u8["K1"] == n_val, f"K1 launched {c_f32['K1']}/{c_u8['K1']}")
        out["camvid_u8_wire"] = {"miou": u8_miou, "ms_per_frame_f32": ms_f32 / n_val,
                                 "ms_per_frame_u8": ms_u8 / n_val,
                                 "pixels": int(u8_conf.sum())}

        # VOC: the R18 student at 21 classes, seeded weights, at 505×505
        n_voc = dict(VOC_FRAMES)["val"]
        argv = ["--data-set", "voc", "--data-dir", voc_root,
                "--data-list", os.path.join(work, "list", "voc", "val.txt"),
                "--device", device.type]
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            miou, ms, counts, peak = _sweep(lambda: eval_cli.main(argv))
        check(0.0 <= miou <= 1.0 and f"meanIU: {miou:.6f}" in buf.getvalue(),
              f"cli.eval --data-set voc: {buf.getvalue()[-200:]}")
        check(counts["K1"] == n_voc, f"the VOC eval launched K1 {counts['K1']} times")
        out["cli_eval_voc"] = {"miou": miou, "seconds": ms / 1e3, "frames": n_voc,
                               "max_memory_allocated": peak,
                               "launches": {k: v for k, v in counts.items() if v}}
        out_dir = os.path.join(work, "voc_out")
        argv = ["--data-set", "voc", "--data-dir", voc_root, "--classes_num", str(VOC_CLASSES),
                "--data-list", os.path.join(work, "list", "voc", "test.txt"),
                "--output-dir", out_dir, "--device", device.type]
        with contextlib.redirect_stdout(io.StringIO()):
            _, ms, counts, peak = _sweep(lambda: test_cli.main(argv))
        pngs = sorted(os.listdir(out_dir))
        check(len(pngs) == dict(VOC_FRAMES)["test"], f"cli.test --data-set voc wrote {pngs}")
        for name in pngs:
            with Image.open(os.path.join(out_dir, name)) as im:
                png = np.asarray(im)
                check(im.mode == "P" and png.shape == (505, 505) and png.max() < VOC_CLASSES,
                      f"{name}: {im.mode} {png.shape} max {png.max()}")
        out["cli_test_voc"] = {"pngs": pngs, "seconds": ms / 1e3, "max_memory_allocated": peak,
                               "launches": {k: v for k, v in counts.items() if v}}
    return out


def phase_camvid_espnet(device: torch.device, card: str) -> dict:
    """Phase 18: the CamVid ESPNet-C path (K2/K3 on a main path), OHEM,
    --remat and the VOC/CamVid CLIs; one line a part."""
    parts = {"step": _camvid_step(device)}
    torch.cuda.empty_cache()
    ce = _camvid_ce_kernels(device)
    parts["ce_kernels"] = {"heads": ce["heads"]}
    # phase 9's step with the full ESPNet-C (7 classes) as the student at
    # 256²: the teacher's 33×33 grid resized to its 32×32, K2/K3 twice
    parts["gpu_vs_cpu"] = _gpu_vs_cpu_step(device, espnet=True)
    torch.cuda.empty_cache()
    parts["ohem"] = _ohem_part(device)
    torch.cuda.empty_cache()
    parts["remat"] = _remat_part(device)
    torch.cuda.empty_cache()
    parts["clis"] = _item7_clis(device)
    for name, fields in parts.items():
        phase(18, f"camvid_espnet/{name}", card=card, **fields)
    return {**parts, "record": ce["record"]}


# --------------------------------------------------------- phase 19: data parallel
DP_CLI_STEPS = 4
# the replayed second step starts from each side's own first update, so its
# losses carry that step's f32 rounding: the port's CPU step tests' envelope
# for a second step (tests/test_torch_port_train_step.py LOSS_RTOL/ATOL[1])
DP_STEP2_RTOL, DP_STEP2_ATOL = 5e-2, 2e-2
DP_EVAL_FRAMES = (("val", 5),)
DP_TIMEOUT_S = 900.0


def _state_flat(state: KDTrainState) -> dict:
    """Every tensor of `_loop_state`, on the host."""
    return {k: v.cpu() for k, v in _loop_state(state).items()}


def _param_names(state: KDTrainState) -> set:
    return {f"{n}.{k}" for n, m in (("student", state.student), ("disc", state.discriminator))
            for k, _ in m.named_parameters()}


def _check_losses(got: list, want: list, what: str, rtol: float = STEP_LOSS_RTOL,
                  atol: float = STEP_LOSS_ATOL) -> dict:
    """Per-step metric dicts within rtol/atol (phase 9's by default); the
    largest relative difference of each metric."""
    worst = {}
    for i, (g, w) in enumerate(zip(got, want)):
        for k, b in w.items():
            a = g[k]
            check(math.isfinite(a) and abs(a - b) <= rtol * abs(b) + atol,
                  f"{what} step {i} {k}: {a} vs {b}")
            worst[k] = max(worst.get(k, 0.0), abs(a - b) / max(abs(b), 1e-30))
    return worst


def _chunk_metrics(metrics: dict) -> list:
    n = len(next(iter(metrics.values())))
    return [{k: float(v[i]) for k, v in metrics.items()} for i in range(n)]


def _rank_rows(chunks: list, rank: int, world: int) -> list:
    return [(torch.stack([shard_rows(x, rank, world) for x in images]),
             torch.stack([shard_rows(x, rank, world) for x in labels]))
            for images, labels in chunks]


def _dp_loop_run(group, device: torch.device, chunks: list, timed: int = 0,
                 unroll: int = LOOP_UNROLL, dtype: torch.dtype = torch.bfloat16) -> dict:
    """Phase 11's fused state (computing in `dtype`) as one rank of `group`
    (ABNs synced, the data-parallel loop of `unroll` steps): the eager
    warm-up chunk, the capture and its replay of the next, then `timed`
    replays of the last chunk. Returns the metrics, the state after each of
    the first two chunks (on the host), the collectives and kernel launches
    of the eager chunk, and the times."""
    cfg = _train_config(unroll_steps=unroll, compute_dtype=(
        "float32" if dtype == torch.float32 else "bfloat16"))
    state, gen = _full_state(cfg, device, bn_fused=True, dtype=dtype)
    if group is not None:
        set_process_group(state.student, group)
        set_process_group(state.discriminator, group)
    loop = make_train_loop(cfg, unroll, group)
    # zero momentum buffers before the first update (which sets them to the
    # gradient, as none would), so the start holds every tensor compared
    for module, opt in ((state.student, state.g_opt), (state.discriminator, state.d_opt)):
        momentum_buffers(opt, [p for p in module.parameters() if p.requires_grad])
    start = _state_flat(state)
    zero_counts()
    all_reduce_sum.calls = all_reduce_sum.bytes = 0
    m0 = loop(state, *chunks[0], unroll, gen)
    torch.cuda.synchronize(device)
    counts = read_counts()
    collectives = {"calls": all_reduce_sum.calls / unroll,
                   "bytes": all_reduce_sum.bytes / unroll}
    after_eager = _state_flat(state)
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    m1 = loop(state, *chunks[1], unroll, gen)
    torch.cuda.synchronize(device)
    capture_wall = 1e3 * (time.perf_counter() - t0)
    check(loop.captures == 1 and loop.replays == 1, "the loop did not capture its second chunk")
    after_graph = _state_flat(state)
    times = [_timed_chunk(lambda: loop(state, *chunks[-1], unroll, gen)) / unroll
             for _ in range(timed)]
    return {"state": state, "loop": loop, "gen": gen, "metrics_eager": _chunk_metrics(m0),
            "metrics_graph": _chunk_metrics(m1), "start": start, "after_eager": after_eager,
            "after_graph": after_graph,
            "counts_eager_per_step": {k: counts[k] / unroll for k in GRAPH_KERNELS},
            "collectives_per_step": collectives, "capture_ms": loop.capture_ms,
            "capture_chunk_wall_ms": capture_wall, "ms_per_step": times,
            "params": _param_names(state)}


def _dp_world1(device: torch.device, chunks: list) -> dict:
    """(a) A world-1 NCCL group: the data-parallel fused loop against phase
    16's loop from the same state on the same chunks; replays timed in
    turns; one profiled replay of each counts its kernels."""
    import torch.distributed as dist

    with tempfile.TemporaryDirectory(prefix="skd_dp_") as tmp:
        dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "rdv"), 1),
                                rank=0, world_size=1, device_id=device)
        try:
            group = dist.group.WORLD
            dp = _dp_loop_run(group, device, chunks)
            ref = _dp_loop_run(None, device, chunks)
            eager_cmp = _compare_loop_states(dp["start"], ref["after_eager"], dp["after_eager"],
                                             dp["params"])
            graph_cmp = _compare_loop_states(dp["start"], ref["after_graph"], dp["after_graph"],
                                             dp["params"])
            bit_equal = all(torch.equal(ref["after_graph"][k], v)
                            for k, v in dp["after_graph"].items())
            losses = _check_losses(dp["metrics_eager"] + dp["metrics_graph"],
                                   ref["metrics_eager"] + ref["metrics_graph"], "world-1")
            ms = {"data_parallel": [], "one_card": []}
            for _ in range(LOOP_TURNS):
                for name, run in (("data_parallel", dp), ("one_card", ref)):
                    ms[name].append(_timed_chunk(
                        lambda: run["loop"](run["state"], *chunks[-1], LOOP_UNROLL, run["gen"]))
                        / LOOP_UNROLL)
            profiled = {name: _profiled_chunk(
                lambda: run["loop"](run["state"], *chunks[-1], LOOP_UNROLL, run["gen"]))
                for name, run in (("data_parallel", dp), ("one_card", ref))}
            n_teacher = _fused_abns(dp["state"].teacher)
            n_student = _fused_abns(dp["state"].student)
            expect = {"K4": LOOP_UNROLL, "K5": LOOP_UNROLL,
                      "K6": (n_teacher + n_student) * LOOP_UNROLL,
                      "K7": n_student * LOOP_UNROLL, "K8": n_student * LOOP_UNROLL}
            for name, p in profiled.items():
                check(p["kernels"] == expect,
                      f"one {name} replay launched {p['kernels']}, expected {expect}")
            per_step = {k: v / LOOP_UNROLL for k, v in expect.items()}
            check(dp["counts_eager_per_step"] == per_step,
                  f"an eager data-parallel step launched {dp['counts_eager_per_step']}")
        finally:
            dist.destroy_process_group()
    out = {"bit_equal_to_one_card": bit_equal, "eager": eager_cmp, "graph": graph_cmp,
           "loss_max_rel_diff": losses, "collectives_per_step": dp["collectives_per_step"],
           "capture_ms": dp["capture_ms"], "one_card_capture_ms": ref["capture_ms"],
           "ms_per_step": ms,
           "images_per_second": {k: [TRAIN_BATCH * 1e3 / t for t in v] for k, v in ms.items()},
           "launches_per_step": dp["counts_eager_per_step"],
           "launches_per_replay": profiled["data_parallel"]["kernels"],
           "busy_share": {k: p["busy_share"] for k, p in profiled.items()}}
    del dp, ref
    torch.cuda.empty_cache()
    return out


def _dp_chunks(device: torch.device) -> list:
    """Phase 19's three chunks of 4 synthetic batches of 8, made alike in
    every process from one seed."""
    return _device_chunks(_train_config(), 3, device, seed=6)


def _worst_updates(start: dict, ref: dict, got: dict, n: int = 6) -> list:
    """The n tensors whose change over a step differs most, relative L2."""
    out = []
    for k, r in ref.items():
        if not r.is_floating_point():
            continue
        d = (r - start[k]).double()
        nr = d.norm().item()
        if nr > 0:
            out.append(((got[k] - start[k]).double().sub(d).norm().item() / nr, k))
    return sorted(out)[-n:]


def _dp_gloo_rank(group) -> dict:
    """(b) One gloo rank on the one card: the fused state, its rows of the
    first batch of 8, one eager data-parallel step in f32 with TF32 off
    (CUDA tensors, gloo collectives); the launches, the losses and the
    state."""
    torch.set_num_threads(2)
    device = torch.device("cuda", 0)
    rank, world = world_of(group)
    cfg = _train_config(compute_dtype="float32")
    state, gen = _full_state(cfg, device, bn_fused=True, dtype=torch.float32)
    set_process_group(state.student, group)
    set_process_group(state.discriminator, group)
    step = make_train_step(cfg, group)
    images, labels = _rank_rows(_dp_chunks(device)[:1], rank, world)[0]
    zero_counts()
    with no_tf32():
        metrics = {k: float(v) for k, v in
                   step(state, images[0].float(), labels[0], gen).items()}
    torch.cuda.synchronize(device)
    counts = {k: read_counts()[k] for k in GRAPH_KERNELS}
    return {"metrics": [metrics], "counts": counts, "state": _state_flat(state)}


def _dp_gloo(device: torch.device, chunks: list) -> dict:
    """(b) Two gloo ranks on the one card (NCCL refuses two ranks on one
    device) against the one-process step at batch 8 on the same card, both
    in f32 with TF32 off (phase 9's setting: in bf16 a step's update is
    not determined to 2 % by the order of its sums)."""
    t0 = time.perf_counter()
    ranks = launch(_dp_gloo_rank, 2, backend="gloo", timeout=DP_TIMEOUT_S)
    took = time.perf_counter() - t0
    cfg = _train_config(compute_dtype="float32")
    state, gen = _full_state(cfg, device, bn_fused=True, dtype=torch.float32)
    for module, opt in ((state.student, state.g_opt), (state.discriminator, state.d_opt)):
        momentum_buffers(opt, [p for p in module.parameters() if p.requires_grad])
    start = _state_flat(state)
    step = make_train_step(cfg)
    with no_tf32():
        ref = [{k: float(v) for k, v in
                step(state, chunks[0][0][0].float(), chunks[0][1][0], gen).items()}]
    ref_state = _state_flat(state)
    worst = _worst_updates(start, ref_state, ranks[0]["state"])
    print(f"phase 19 data_parallel (b): worst update differences {worst}", flush=True)
    for r in ranks[1:]:
        for k, v in ranks[0]["state"].items():
            check(torch.equal(r["state"][k], v), f"the gloo ranks differ in {k}")
    n_teacher, n_student = _fused_abns(state.teacher), _fused_abns(state.student)
    expect = {"K4": 1, "K5": 1, "K6": n_teacher + n_student, "K7": n_student, "K8": n_student}
    for r in ranks:
        check(r["counts"] == expect, f"a gloo rank's step launched {r['counts']}, "
                                     f"expected {expect}")
    losses = [_check_losses(r["metrics"], ref, "gloo rank") for r in ranks]
    tensors = _compare_loop_states(start, ref_state, ranks[0]["state"], _param_names(state))
    del state
    torch.cuda.empty_cache()
    return {"ranks": 2, "seconds": took, "launches_per_step": ranks[0]["counts"],
            "loss_max_rel_diff": losses[0], "ranks_bit_identical": True, **tensors}


def _dp_f32_steps(chunks: list) -> list:
    """The first step of each chunk, in f32: the chunks of the N-rank
    equivalence, one step each (an eager step, then a captured one)."""
    return [(images[:1].float(), labels[:1]) for images, labels in chunks]


def _dp_nccl_rank(group) -> dict:
    """(c) One NCCL rank of N on `cuda:rank`: its rows of the global batch 8
    in f32 with TF32 off (an eager step, then a captured one and its
    replay: phase 9's setting, as (b)), then a fresh bf16 loop at batch 8 a
    rank (global 8·N), replays timed."""
    torch.set_num_threads(2)
    rank, world = world_of(group)
    device = torch.device("cuda", rank)
    full = _dp_chunks(device)
    with no_tf32():
        small = _dp_loop_run(group, device, _rank_rows(_dp_f32_steps(full), rank, world),
                             unroll=1, dtype=torch.float32)
    # the states travel from rank 0 only; every rank sends a digest
    digest = hashlib.sha256()
    for k in sorted(small["after_graph"]):
        digest.update(small["after_graph"][k].reshape(-1).view(torch.uint8).numpy().tobytes())
    out = {"metrics": small["metrics_eager"] + small["metrics_graph"],
           "digest": digest.hexdigest(),
           **({"after_eager": small["after_eager"], "after_graph": small["after_graph"]}
              if rank == 0 else {}),
           "collectives_per_step": small["collectives_per_step"],
           "counts_eager_per_step": small["counts_eager_per_step"],
           "capture_ms": small["capture_ms"]}
    del small
    torch.cuda.empty_cache()
    big = _dp_loop_run(group, device, full, timed=LOOP_TURNS)
    profiled = _profiled_chunk(
        lambda: big["loop"](big["state"], *full[-1], LOOP_UNROLL, big["gen"]))
    out.update(ms_per_step_batch8=big["ms_per_step"], capture_ms_batch8=big["capture_ms"],
               busy_share_batch8=profiled["busy_share"], kernels_per_replay=profiled["kernels"])
    return out


def _dp_cli(n: int, device: torch.device) -> dict:
    """(c) `cli.train --num-data-shards n` (synthetic, a checkpoint at step 2,
    a resume to step 4) and `cli.eval --num-data-shards n` on fake frames
    against `--num-data-shards 1`."""
    with tempfile.TemporaryDirectory(prefix="skd_dp_cli_") as work:
        common = ["--data-set", "synthetic", "--batch-size", str(TRAIN_BATCH),
                  "--input-size", "%d,%d" % TRAIN_CROP, "--log-every", "1", "--eval-every", "2",
                  "--device", device.type, "--num-data-shards", str(n),
                  "--snapshot-dir", os.path.join(work, "snap"), "--S_ckpt_path", ""]
        t0 = time.perf_counter()
        train_cli.main(common + ["--num-steps", "2", "--log-path", os.path.join(work, "log1")])
        train_cli.main(common + ["--num-steps", str(DP_CLI_STEPS), "--S_resume", "true",
                                 "--log-path", os.path.join(work, "log2")])
        train_s = time.perf_counter() - t0
        rows1, rows2 = _scalars(os.path.join(work, "log1")), _scalars(os.path.join(work, "log2"))
        steps = [r["step"] for r in rows1 + rows2 if "g_loss" in r]
        check(steps == list(range(1, DP_CLI_STEPS + 1)), f"the N-rank CLI logged steps {steps}")
        for r in rows1 + rows2:
            check(all(math.isfinite(v) for v in r.values()), f"a value is not finite: {r}")
        latest = sorted(os.listdir(os.path.join(work, "snap", "latest")))
        check(latest == ["step_00000002.pth", "step_00000004.pth"], f"latest/ holds {latest}")
        root = os.path.join(work, "cityscapes")
        write_fake_cityscapes(root, frames=DP_EVAL_FRAMES, seed=5)
        lists = make_cityscapes_lists(root, os.path.join(work, "list"))
        base = ["--data-dir", root, "--data-list", lists["val"], "--device", device.type]
        with contextlib.redirect_stdout(io.StringIO()):
            one = eval_cli.main(base)
            t0 = time.perf_counter()
            many = eval_cli.main(base + ["--num-data-shards", str(n)])
            eval_s = time.perf_counter() - t0
        check(many == one, f"the {n}-rank sweep's mIoU {many} differs from one card's {one}")
    return {"train_seconds": train_s, "steps": steps, "latest": latest,
            "img_per_sec": [r["img_per_sec"] for r in rows2 if "img_per_sec" in r],
            "eval_miou": many, "eval_miou_one_card": one, "eval_seconds": eval_s}


def _dp_multi(n: int, device: torch.device, ref: dict) -> dict:
    """(c) N NCCL ranks, one a card, against the one-card loop `ref`."""
    t0 = time.perf_counter()
    ranks = launch(_dp_nccl_rank, n, backend="nccl", timeout=DP_TIMEOUT_S)
    took = time.perf_counter() - t0
    check(len({r["digest"] for r in ranks}) == 1, "the NCCL ranks' states differ")
    # the eager first step from the same state: phase 9's tolerances and the
    # 2 % rule on every update; the replayed second step from each side's
    # own first update: its losses at the second-step envelope, and its
    # state's differences reported
    losses = _check_losses(ranks[0]["metrics"][:1], ref["metrics_eager"], f"{n}-rank eager")
    losses_replay = _check_losses(ranks[0]["metrics"][1:], ref["metrics_graph"],
                                  f"{n}-rank replay", DP_STEP2_RTOL, DP_STEP2_ATOL)
    eager_cmp = _compare_loop_states(ref["start"], ref["after_eager"], ranks[0]["after_eager"],
                                     ref["params"])
    graph_worst = _worst_updates(ref["start"], ref["after_graph"], ranks[0]["after_graph"])
    ms = [statistics.median(r["ms_per_step_batch8"]) for r in ranks]
    return {"ranks": n, "seconds": took, "loss_max_rel_diff": losses,
            "replay_loss_max_rel_diff": losses_replay, "eager": eager_cmp,
            "replay_worst_update_differences": graph_worst,
            "collectives_per_step": ranks[0]["collectives_per_step"],
            "launches_per_step": ranks[0]["counts_eager_per_step"],
            "capture_ms": ranks[0]["capture_ms"],
            "batch8_per_rank": {"ms_per_step": [r["ms_per_step_batch8"] for r in ranks],
                                "images_per_second": n * TRAIN_BATCH * 1e3 / max(ms),
                                "capture_ms": [r["capture_ms_batch8"] for r in ranks],
                                "busy_share": [r["busy_share_batch8"] for r in ranks],
                                "kernels_per_replay": ranks[0]["kernels_per_replay"]},
            "cli": _dp_cli(n, device)}


def phase_data_parallel(device: torch.device, card: str) -> dict:
    """Phase 19: data parallelism. (a) a world-1 NCCL group against phase
    16's loop; (b) two gloo ranks on the one card against the one-process
    step; (c) with two or more cards, N NCCL ranks."""
    chunks = _dp_chunks(device)
    t0 = time.perf_counter()
    world1 = _dp_world1(device, chunks)
    gloo = _dp_gloo(device, chunks)
    n = torch.cuda.device_count()
    if n >= 2:
        run = subprocess.run(["nvidia-smi", "topo", "-m"], capture_output=True, text=True,
                             timeout=60)
        topo = run.stdout + run.stderr
        print("phase 19 data_parallel (c): nvidia-smi topo -m\n" + topo, flush=True)
        with no_tf32():
            ref = _dp_loop_run(None, device, _dp_f32_steps(chunks), unroll=1,
                               dtype=torch.float32)
        multi = _dp_multi(n, device, ref)
        del ref
        torch.cuda.empty_cache()
    else:
        multi = {"ran": False, "why": f"{n} CUDA device: N NCCL ranks need one card each"}
        print(f"phase 19 data_parallel (c): not run: {multi['why']}", flush=True)
    phase(19, "data_parallel", card=card, seconds=time.perf_counter() - t0,
          model="R101 teacher -> R18 student, bn_fused, full width, bf16 convs, batch 8, 512^2",
          world1_nccl=world1, gloo_two_ranks=gloo, nccl_ranks=multi)
    return {"world1": world1, "gloo": gloo, "multi": multi}


# ------------------------------------------------------------- phase 20: export
EX_TURNS = 3
EX_FOLD_REL = 1e-3  # cli.export's fold parity rule
EX_TEACHER_BATCH = 8
EX_TEACHER_CROP = (512, 512)
EX_TEACHER_REPS = 5
EX_PROGRAM_CODE = """
import sys
for name in ("structure_knowledge_distillation_tpu_torch", "structure_knowledge_distillation_tpu",
             "jax", "flax"):
    sys.modules[name] = None
try:
    import structure_knowledge_distillation_tpu_torch
    sys.exit("the port imported")
except ImportError:
    pass
import time
import numpy as np
import torch
frames = np.load(sys.argv[1])
out = {}
for path in sys.argv[3:]:
    t0 = time.perf_counter()
    prog = torch.export.load(path).module()
    load_s = time.perf_counter() - t0
    with torch.no_grad():
        maps = [prog(torch.from_numpy(f[None]).cuda()).cpu().numpy()[0] for f in frames]
    out[path] = np.stack(maps)
    print(path, "load_seconds", load_s, flush=True)
np.savez(sys.argv[2], *[out[p] for p in sys.argv[3:]])
"""


def _folded_copy(model: ResPSPNet, **kw) -> ResPSPNet:
    """`ResPSPNet(fold_bn=True)` (or with `kw`) of `model`'s block and
    layers on its device, holding `model`'s weights with its ABNs folded."""
    layers = tuple(len(getattr(model, f"layer{i}")) for i in range(1, 5))
    device = next(model.parameters()).device
    folded = ResPSPNet(model.block, layers, NUM_CLASSES, device=device, fold_bn=True, **kw)
    folded.load_state_dict(fold_bn_state_dict(model.state_dict()), strict=True)
    return folded.eval()


def _pinned_frames(frames: list) -> list:
    """Each eval frame as pinned host tensors: the f32 NHWC image, the same
    image raw (mean added back, the serving program's input) and the label."""
    mean = np.asarray(IMG_MEAN_BGR, np.float32)
    return [(torch.from_numpy(image).pin_memory(),
             torch.from_numpy(image + mean).pin_memory(),
             torch.from_numpy(label[0].astype(np.uint8)).pin_memory())
            for image, label, _, _ in frames]


def _eval_variants(models: dict, programs: dict, pinned: list, device) -> dict:
    """ms per frame of each fast path (`make_fast_val_fn`: forward, K1,
    mask, confusion) and each serving program (forward, resize, argmax),
    host clock around a sweep of the frames synchronised once at its end,
    every frame crossing by a pinned non-blocking copy; EX_TURNS turns, the
    variants in turn within each."""
    h, w = FULL_RES

    def fast(fn):
        def sweep():
            for image, _, label in pinned:
                x = to_nchw(image.to(device, non_blocking=True))
                fn(x, label.to(device, non_blocking=True), h, w)
        return sweep

    def serve(prog):
        def sweep():
            for _, raw, _ in pinned:
                prog(raw.to(device, non_blocking=True))
        return sweep

    sweeps = {**{k: fast(make_fast_val_fn(m, FULL_RES, NUM_CLASSES)) for k, m in models.items()},
              **{k: serve(p) for k, p in programs.items()}}
    times = {k: [] for k in sweeps}
    with torch.no_grad():
        for sweep in sweeps.values():  # warm-up (cuDNN's choices)
            sweep()
        for _ in range(EX_TURNS):
            for k, sweep in sweeps.items():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sweep()
                torch.cuda.synchronize()
                times[k].append(1e3 * (time.perf_counter() - t0) / len(pinned))
        profiled = {k: _profiled_chunk(sweep) for k, sweep in sweeps.items()}
    n = len(pinned)
    return {k: {"ms_per_frame": statistics.median(v), "turns": v,
                "profiled_ms_per_frame": profiled[k]["wall_ms"] / n,
                "device_busy_ms_per_frame": profiled[k]["device_busy_ms"] / n,
                "busy_share": profiled[k]["busy_share"]} for k, v in times.items()}


def _kernel_table(fn, top: int = 8) -> dict:
    """One `fn()` under torch.profiler: the device's kernel ms in all and
    the `top` kernel names by summed device time (ms, launches)."""
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    ms, launches = Counter(), Counter()
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms[e.name] += (e.time_range.end - e.time_range.start) / 1e3
            launches[e.name] += 1
    return {"kernel_ms": sum(ms.values()), "launches": sum(launches.values()),
            "top": [{"name": k[:90], "ms": v, "launches": launches[k]}
                    for k, v in ms.most_common(top)]}


def _export_fold_on_card(device) -> tuple:
    """(a): the folded student against the unfolded one at 1024×2048."""
    plain = _eval_student(device)
    folded = _folded_copy(plain)
    frames = _eval_frames()
    x = to_nchw(torch.from_numpy(frames[0][0]).to(device))
    with torch.no_grad():
        with no_tf32():
            rel = export_cli.rel_logit_diff(plain(x)[0], folded(x)[0])
        rel_tf32 = export_cli.rel_logit_diff(plain(x)[0], folded(x)[0])
    check(rel <= EX_FOLD_REL, f"folded logits differ by {rel} (relative, TF32 off)")
    miou, conf, took, counts = _timed_eval(folded, frames, device)
    miou_plain, _, _ = evaluate_main(plain, frames, NUM_CLASSES, out_size=FULL_RES, device=device)
    check(counts["K1"] == FRAMES, f"the folded sweep launched K1 {counts['K1']} times")
    check(counts["K6"] == 0, f"the folded sweep launched K6 {counts['K6']} times")
    check(int(conf.sum()) == sum(int((b[1] != 255).sum()) for b in frames),
          "folded confusion count is off")
    check(abs(miou - miou_plain) <= EVAL_MIOU_ATOL, f"folded mIoU {miou} vs unfolded {miou_plain}")
    fold = {"logits_rel_diff": rel, "logits_rel_diff_tf32": rel_tf32, "rel_tol": EX_FOLD_REL,
            "miou": miou, "miou_unfolded": miou_plain, "sweep_ms_per_frame": 1e3 * took / FRAMES,
            "launches": {"K1": counts["K1"], "K6": counts["K6"]}}
    return plain, folded, frames, fold


def _export_programs(device, plain, work: str) -> dict:
    """(b): `cli.export.main` on the card, --fold-bn, f32 and bf16 classmap
    programs at (1, 1024, 2048, 3)."""
    pth = os.path.join(work, "student.pth")
    torch.save({k: v.cpu() for k, v in plain.state_dict().items()}, pth)
    out = {}
    for dt in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        export_cli.main(["--checkpoint", pth, "--output", os.path.join(work, dt), "--fold-bn",
                         "--device", "cuda", "--program-output", os.path.join(work, f"{dt}.pt2"),
                         "--program-size", "%d,%d" % FULL_RES, "--program-dtype", dt])
        with open(os.path.join(work, dt + ".json")) as f:
            meta = json.load(f)
        check(meta["fold_max_logit_diff"] <= EX_FOLD_REL, f"cli.export parity {meta}")
        check(meta["program"]["input"] == [1, *FULL_RES, 3], f"program input {meta['program']}")
        out[dt] = {"cli_seconds": time.perf_counter() - t0,
                   "export_seconds": meta["program"]["seconds"],
                   "bytes": meta["program"]["bytes"], "path": meta["program"]["path"],
                   "fold_max_logit_diff": meta["fold_max_logit_diff"]}
    return out


def _fresh_process_maps(frames: list, paths: list, work: str) -> tuple:
    """Run the programs in a fresh `python3` in which importing the port
    raises (cwd a scratch directory, the package names blocked): their class
    maps over the raw frames, and the load seconds it printed."""
    mean = np.asarray(IMG_MEAN_BGR, np.float32)
    raw = np.concatenate([image + mean for image, _, _, _ in frames])
    np.save(os.path.join(work, "raw.npy"), raw)
    maps = os.path.join(work, "maps.npz")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", EX_PROGRAM_CODE, os.path.join(work, "raw.npy"),
                           maps, *paths], cwd=work, capture_output=True, text=True, timeout=600)
    took = time.perf_counter() - t0
    check(proc.returncode == 0, f"the fresh process failed: {proc.stdout}\n{proc.stderr}")
    loaded = np.load(maps)
    return ([torch.from_numpy(loaded[f"arr_{i}"]) for i in range(len(paths))],
            proc.stdout.strip().splitlines(), took)


def _mismatch(a: list, b: list) -> float:
    return float(sum(int((x != y).sum()) for x, y in zip(a, b)) / sum(x.numel() for x in a))


def _teacher_fold(device) -> dict:
    """(d): the R101 teacher's eval forward at batch 8, 512², bf16, no grad:
    unfolded, bn_fused and folded, device ms in turns; the folded f32
    logits against the unfolded ones with TF32 off."""
    plain = teacher_model(NUM_CLASSES, device=device, generator=torch.Generator().manual_seed(2))
    randomize_bn_stats(plain, 3)
    plain.eval()
    x = torch.randn((EX_TEACHER_BATCH, 3, *EX_TEACHER_CROP),
                    generator=torch.Generator().manual_seed(9)).mul_(60.0).to(device)
    with torch.no_grad():
        folded32 = _folded_copy(plain)
        with no_tf32():
            rel = export_cli.rel_logit_diff(plain(x)[0], folded32(x)[0])
        del folded32
        check(rel <= EX_FOLD_REL, f"folded teacher logits differ by {rel} (relative, TF32 off)")
        layers = (3, 4, 23, 3)
        variants = {}
        for name, kw in (("unfolded", {}), ("bn_fused", {"bn_fused": True})):
            m = ResPSPNet(BOTTLENECK, layers, NUM_CLASSES, device=device, dtype=torch.bfloat16, **kw)
            m.load_state_dict(plain.state_dict())
            variants[name] = m.eval()
        variants["folded"] = _folded_copy(plain, dtype=torch.bfloat16)
        rel_bf16 = export_cli.rel_logit_diff(variants["unfolded"](x)[0], variants["folded"](x)[0])
        times = {k: [] for k in variants}
        for _ in range(EX_TURNS):
            for k, m in variants.items():
                times[k].append(cuda_median_ms(lambda m=m: m(x), reps=EX_TEACHER_REPS, trials=1))
        kernels = {k: _kernel_table(lambda m=m: m(x)) for k, m in variants.items()}
        zero_counts()
        variants["folded"](x)
        counts = read_counts()
    check(counts["K6"] == 0, f"the folded teacher launched K6 {counts['K6']} times")
    del variants, plain
    torch.cuda.empty_cache()
    return {"batch": EX_TEACHER_BATCH, "crop": list(EX_TEACHER_CROP), "dtype": "bfloat16",
            "logits_rel_diff_f32": rel, "logits_rel_diff_bf16": rel_bf16,
            **{f"{k}_ms": {"median": statistics.median(v), "turns": v} for k, v in times.items()},
            "profiled": kernels}


def phase_export(device: torch.device, card: str) -> dict:
    """Phase 20: the inference export (`models/fold.py`, `cli/export.py`)."""
    t0 = time.perf_counter()
    plain, folded, frames, fold = _export_fold_on_card(device)
    maps_before, _ = _class_maps(make_fast_val_fn(folded, FULL_RES, NUM_CLASSES), frames, device)
    with tempfile.TemporaryDirectory(prefix="skd_export_") as work:
        programs = _export_programs(device, plain, work)
        # the trace left the eager path alone: same maps, real cached operators
        maps_after, _ = _class_maps(make_fast_val_fn(folded, FULL_RES, NUM_CLASSES), frames,
                                    device)
        check(all(torch.equal(a, b) for a, b in zip(maps_before, maps_after)),
              "the folded fast path changed after the export")
        for n_in, n_out in ((129, 1024), (257, 2048), (6, 129)):
            t = interp_matrix_align_corners(n_in, n_out, device)
            check(type(t) is torch.Tensor, f"a {type(t).__name__} in the resize cache")
        paths = [programs[dt]["path"] for dt in ("float32", "bfloat16")]
        (maps32, maps16), load_lines, fresh_s = _fresh_process_maps(frames, paths, work)
        loaded = {dt: torch.export.load(programs[dt]["path"]).module()
                  for dt in ("float32", "bfloat16")}
        plain_maps, _ = _class_maps(make_fast_val_fn(plain, FULL_RES, NUM_CLASSES), frames, device)
        vs_fast = _mismatch(maps32, maps_before)
        vs_unfolded = _mismatch(maps32, plain_maps)
        check(vs_fast <= MISMATCH_SHARE_MAX, f"f32 program vs K1 fast path: {vs_fast} of pixels")
        bf16 = _folded_copy(plain, dtype=torch.bfloat16)
        mean = torch.tensor(IMG_MEAN_BGR, dtype=torch.float32, device=device)
        want16 = []
        with torch.no_grad():
            for image, _, _, _ in frames:
                raw = torch.from_numpy(image).to(device) + mean
                logits = bf16(to_nchw(raw - mean))[0].float()
                up = resize_bilinear_align_corners(logits, FULL_RES)
                want16.append(up.argmax(1)[0].to(torch.uint8).cpu())
        vs_eager16 = _mismatch(maps16, want16)
        check(vs_eager16 <= MISMATCH_SHARE_MAX, f"bf16 program vs bf16 eager: {vs_eager16}")
        fused = ResPSPNet(BASIC, (2, 2, 2, 2), NUM_CLASSES, device=device, bn_fused=True)
        fused.load_state_dict(plain.state_dict())
        models = {"unfolded_fast": plain, "bn_fused_fast": fused.eval(), "folded_fast": folded}
        timing = _eval_variants(models, {"program_f32": loaded["float32"],
                                         "program_bf16": loaded["bfloat16"]},
                                _pinned_frames(frames), device)
        del loaded, bf16, fused
    teacher = _teacher_fold(device)
    phase(20, "export", card=card, seconds=time.perf_counter() - t0,
          model=f"student R18 full width, f32 unless named; teacher R101 bf16 batch "
                f"{EX_TEACHER_BATCH} at {EX_TEACHER_CROP[0]}x{EX_TEACHER_CROP[1]}",
          fold=fold, programs={**programs, "fresh_process_seconds": fresh_s,
                               "fresh_process_load": load_lines,
                               "f32_vs_k1_fast_path_mismatch": vs_fast,
                               "f32_vs_unfolded_fast_path_mismatch": vs_unfolded,
                               "bf16_vs_bf16_eager_mismatch": vs_eager16,
                               "mismatch_max": MISMATCH_SHARE_MAX},
          eval_ms=timing, teacher=teacher)
    return {"launches": fold["launches"], "eval_ms": timing, "teacher": teacher}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    card = phase_device()
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    phase_build()
    only = {"data_parallel": phase_data_parallel, "export": phase_export}
    if len(argv) == 2 and argv[0] == "--only" and argv[1] in only:
        # one phase alone: phase 19 for a run on several cards, phase 20 to try it
        only[argv[1]](device, card)
        print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                                 "kind": torch.cuda.get_device_name(0),
                                                 "count": torch.cuda.device_count()}}),
              flush=True)
        return 0
    check(not argv, f"unknown arguments {argv}: none, or --only data_parallel|export")
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
    phase_train_cityscapes(device, card, train["ms_per_step"])
    phase_train_loop(device, card)
    eval_modes = phase_eval_modes(device)
    camvid = phase_camvid_espnet(device, card)
    clis = camvid["clis"]
    dp = phase_data_parallel(device, card)
    export = phase_export(device, card)
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
        # they never do); batch8: evaluate_sharded's group, timed in phase 3
        **k1,
        "eval_modes_launches": {p: eval_modes[p]["launches"].get("K1", 0)
                                for p in ("fast_f32", "fast_u8", "sharded")},
        # phase 18: the CamVid eval at (1,11,45,60)->(360,480) in the train
        # CLI and the VOC eval at (1,21,64,64)->(505,505)
        "camvid_voc_launches": {"cli_train_camvid": clis["cli_train_camvid"]["launches"]["K1"],
                                "cli_eval_voc": clis["cli_eval_voc"]["launches"]["K1"]},
        # phase 20: the folded student's sweep (ResPSPNet(fold_bn=True)), once a frame
        "folded_eval_launches": export["launches"]["K1"],
    }]
    ce_source = "structure_knowledge_distillation_tpu_torch/csrc/upsampled_ce.cu"
    pallas_ce = "structure_knowledge_distillation_tpu/ops/pallas_ce.py"
    # K4/K5 carry the R18 train step (heads of one shape); K2/K3 the CamVid
    # ESPNet-C step, whose heads differ (45×60 and 90×120): launches are
    # phase 18's 4 eager CamVid steps (2 a step), and errors, ms, plain_ms
    # and bound_ms those of one step's two calls summed at the CamVid shapes
    # in bf16 (per head in `per_head`; phase 7's R18-shape numbers in
    # `r18_shape`). Errors: |loss − plain| for a forward, max |grad − plain|
    # for a backward; ms: device time of that kernel.
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
        entry = {"name": name, "route": "cuda", "source": ce_source,
                 "replaces": f"{pallas_ce}:{line}", "on_main_path": True, "design": design}
        if key in ("K2", "K3"):
            entry.update(path="train (CamVid ESPNet-C)",
                         launches=camvid["step"]["launches"][key],
                         launches_per_step=camvid["step"]["launches_per_step"][key],
                         r18_train_launches=train["launches"][key], **camvid["record"][key],
                         r18_shape=ce[key])
        else:
            entry.update(path="train", launches=train["launches"][key], **ce[key],
                         data_parallel_launches_per_rank_step=dp["gloo"]["launches_per_step"][key])
        kernels.append(entry)
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
                        "eval_launches": eval_n, **bn[key],
                        "data_parallel_launches_per_rank_step":
                            dp["gloo"]["launches_per_step"][key]})
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
