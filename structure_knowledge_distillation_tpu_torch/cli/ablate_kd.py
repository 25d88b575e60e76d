"""Controlled "KD helps" ablation: a teacher, then four students trained and
scored on the same toy task.

    python -m structure_knowledge_distillation_tpu_torch.cli.ablate_kd \
        [--arm-steps 300] [--teacher-steps 1200] [--train-chunks 0] \
        [--seeds 0,1] [--out ablate_kd.json] [--state-dir ablate_kd_state]

Counterpart of `scripts/ablate_kd.py`, with its flags, constants, arms and
results JSON, built from the port's own modules. The task is synthetic but
learnable: smooth per-class fields (FIELD_RES² normal draws, bilinearly
upsampled to SIZE²) give the argmax labels, and each image is its labels'
palette colours plus heavy pixel noise (σ = NOISE_SIGMA against colours ~60
apart, with two confusable pairs), so a teacher's soft posteriors carry
information beyond the hard labels. A higher-capacity teacher (Bottleneck
blocks) trains on the task loss alone; then four students (Basic blocks)
train from identical inits on identical batches under one budget:

    none       the task loss (DSN cross-entropy) alone
    pi         + lambda_pi * pixel-wise KL
    pi+pa      + lambda_pa * pairwise affinity
    pi+pa+ho   + lambda_d  * holistic adversarial (the SAGAN D and its step)

Each leg runs the production loop (`make_train_loop`, a CUDA-graph replay
per chunk of UNROLL steps on the card, with the DSN cross-entropy through
the kernels K4/K5), and each model is scored by the eval fast path
(`make_fast_val_batch_fn`, K1 once per group of BATCH frames) over
VAL_IMAGES frames. On the card the convolutions run in bf16; `--cpu` (the
JAX spelling of `--device cpu`) runs f32 with the materialised
cross-entropy, as the JAX script's `--cpu`.

Data is made on the device from a `torch.Generator` per (seed, chunk), with
the JAX script's stream rules: every arm of one seed sees the same batches,
the teacher leg is seed 999, validation frame group i has its own stream,
disjoint from every train stream, and `--train-chunks N` > 0 cycles the arms
through N fixed chunks (the reference's finite-data regime). Torch draws
with Philox where JAX draws with threefry, so the data matches the JAX
script's in distribution, not in value.

`--state-dir` caches finished legs: the trained teacher as
`teacher_<backend>_s<steps>.pt` (its state dict) + `.json`, and each
(arm, seed) as `arm_<name>_<seed>_<backend>_s<teacher steps>_a<arm
steps>[_tc<N>].json`; a rerun trains only the legs that are missing. The
results JSON has the JAX artifact's keys plus `device`, the card's name and
power limit as `nvidia-smi` reports them. Each leg prints its steps
(eager, replayed), capture ms, ms per replayed step, wall, and its device
memory: allocated at its start (the previous leg freed) and at its peak.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import tempfile
import time
from typing import Iterable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ResPSPNet
from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    iu_from_confusion,
    make_fast_val_batch_fn,
)
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_loop

SIZE = 256          # smallest resolution with valid SAGAN D geometry (os8=33)
CLASSES = 6
BATCH = 8
UNROLL = 10
FIELD_RES = 16      # class fields upsampled FIELD_RES -> SIZE (blob scale)
NOISE_SIGMA = 90.0  # vs palette separation ~60: boundaries genuinely ambiguous
VAL_IMAGES = 64

LAYERS = (1, 1, 1, 1)
TEACHER_SEED = 999
TRAIN_STREAM = 7000      # train data of seed s: stream (7000 + s, chunk)
VAL_STREAM = 10 ** 6     # val frame group i: stream (10**6, i)
PROGRESS_EVERY = 20      # chunks between progress lines
OUT = os.path.join(tempfile.gettempdir(), "ablate_kd.json")
STATE_DIR = os.path.join(tempfile.gettempdir(), "ablate_kd_state")
ARMS = (
    ("none", dict(pi=False, pa=False, ho=False)),
    ("pi", dict(pi=True, pa=False, ho=False)),
    ("pi+pa", dict(pi=True, pa=True, ho=False)),
    ("pi+pa+ho", dict(pi=True, pa=True, ho=True)),
)
ARM_NAMES = tuple(name for name, _ in ARMS)


def _palette() -> np.ndarray:
    """(C,3) class colors in mean-subtracted BGR range, with deliberately
    CLOSE pairs (0,1) and (2,3): dark knowledge is about relative class
    similarity, so the toy task needs confusable classes."""
    return np.array(
        [
            [-80.0, -80.0, 60.0],
            [-60.0, -80.0, 60.0],   # close to 0
            [60.0, -20.0, -80.0],
            [60.0, 0.0, -60.0],     # close to 2
            [-20.0, 90.0, 20.0],
            [90.0, 60.0, -20.0],
        ],
        np.float32,
    )[:CLASSES]


# ---- the task, generated on the device


def stream_seed(*words: int) -> int:
    """The 64-bit generator seed of the stream named by `words`: distinct
    names give unrelated seeds (numpy's SeedSequence hash)."""
    return int(np.random.SeedSequence([int(w) for w in words]).generate_state(1, np.uint64)[0])


def data_seed(seed: int, chunk: int) -> int:
    """Train chunk `chunk` of seed `seed`: the same for every arm."""
    return stream_seed(TRAIN_STREAM + seed, chunk)


def val_seed(i: int) -> int:
    return stream_seed(VAL_STREAM, i)


def data_chunk(chunk: int, train_chunks: int) -> int:
    """The data chunk that train chunk `chunk` reads: with a finite pool of
    `train_chunks` > 0, the pool cycled as epochs."""
    return chunk % train_chunks if train_chunks else chunk


def _generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def render(fields: torch.Tensor, noise: torch.Tensor,
           palette: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, FIELD_RES, FIELD_RES, C) class fields and (B, SIZE, SIZE, 3) unit
    noise → (B, 3, SIZE, SIZE) f32 images and (B, SIZE, SIZE) int32 labels:
    the fields upsampled bilinearly (half-pixel centres, edges clamped, as
    `jax.image.resize` upsamples), their argmax the labels, the labels'
    colours plus NOISE_SIGMA·noise the images."""
    up = F.interpolate(fields.permute(0, 3, 1, 2), size=(SIZE, SIZE), mode="bilinear",
                       align_corners=False)
    labels = up.argmax(dim=1)
    images = palette[labels] + NOISE_SIGMA * noise
    return images.permute(0, 3, 1, 2).contiguous(), labels.to(torch.int32)


def gen_batch(generator: torch.Generator, batch: int,
              palette: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One batch drawn from `generator` on its device."""
    device = palette.device
    fields = torch.randn((batch, FIELD_RES, FIELD_RES, CLASSES), generator=generator,
                         device=device)
    noise = torch.randn((batch, SIZE, SIZE, 3), generator=generator, device=device)
    return render(fields, noise, palette)


def gen_chunk(seed: int, chunk: int, unroll: int, batch: int,
              palette: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Data chunk `chunk` of seed `seed`, stacked as `TrainLoop` takes it:
    (unroll, batch, 3, SIZE, SIZE) images and (unroll, batch, SIZE, SIZE)
    labels."""
    g = _generator(data_seed(seed, chunk), palette.device)
    batches = [gen_batch(g, batch, palette) for _ in range(unroll)]
    return torch.stack([b[0] for b in batches]), torch.stack([b[1] for b in batches])


def val_batch(i: int, batch: int, palette: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    return gen_batch(_generator(val_seed(i), palette.device), batch, palette)


# ---- configuration, models and state


def make_cfg(pi: bool, pa: bool, ho: bool, num_steps: int, device="cuda", batch: int = BATCH,
             unroll: int = UNROLL) -> TrainConfig:
    """A leg's TrainConfig: the reference run-script weights; on the card
    bf16 convolutions and the fused cross-entropy (K4/K5), on the CPU f32
    and the materialised one, as the JAX script's `--cpu`."""
    on_card = torch.device(device).type == "cuda"
    return TrainConfig(
        data_set="synthetic", classes_num=CLASSES, batch_size=batch,
        input_size=(SIZE, SIZE), num_steps=num_steps,
        pi=pi, pa=pa, ho=ho,
        lambda_pi=10.0, lambda_pa=0.5, lambda_d=0.1, pool_scale=0.5,
        imsize_for_adv=33, adv_conv_dim=16,
        compute_dtype="bfloat16" if on_card else "float32",
        fused_ce="true" if on_card else "false",
        unroll_steps=unroll, device=str(device),
    )


def _dtype(cfg: TrainConfig) -> Optional[torch.dtype]:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else None


def make_model(cfg: TrainConfig, block: str, generator: torch.Generator) -> ResPSPNet:
    """The full-width ResPSPNet of `block` with LAYERS, drawn from
    `generator`, on the config's device."""
    return ResPSPNet(block, LAYERS, cfg.classes_num, device=torch.device(cfg.device),
                     dtype=_dtype(cfg), generator=generator)


def make_discriminator(cfg: TrainConfig, generator: torch.Generator) -> Discriminator:
    return Discriminator(cfg.classes_num, preprocess_mode=cfg.preprocess_gan_mode,
                         image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim,
                         dtype=_dtype(cfg), device=torch.device(cfg.device),
                         generator=generator)


def make_state(cfg: TrainConfig, teacher, student, disc) -> KDTrainState:
    """SGD with momentum and weight decay for G and D, and their poly
    schedules over `cfg.num_steps`."""
    return KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def build(cfg: TrainConfig, block: str, teacher, seed: int):
    """A leg's state and loop: the student of `block` and then D drawn from
    `torch.Generator().manual_seed(seed)`, which then draws the steps'
    dropout masks and GP α (returned as the third value). Every leg gets a
    loop of its own: a captured graph reads this state's tensors by
    address."""
    generator = torch.Generator().manual_seed(seed)
    student = make_model(cfg, block, generator)
    disc = make_discriminator(cfg, generator)
    state = make_state(cfg, teacher, student, disc)
    return state, make_train_loop(cfg, cfg.unroll_steps), generator


# ---- train and evaluate


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train(state: KDTrainState, loop, generator: torch.Generator, steps: int, seed: int,
          palette: torch.Tensor, train_chunks: int = 0, batch: int = BATCH, tag: str = "",
          t0: float = 0.0) -> dict:
    """`steps // unroll` full chunks of seed `seed`'s data through `loop`.
    Returns the last step's g_loss (`final_loss`), the mean g_loss of the
    first and the last chunk, the loop's counters and timings: ms per
    replayed step is timed from the end of the capture chunk to the end of
    the leg (data generation included)."""
    unroll = loop.unroll
    n_chunks = steps // unroll
    if n_chunks < 1:
        raise ValueError(f"{tag}: {steps} steps make no full chunk of {unroll}")
    device = palette.device
    _sync(device)
    start = time.perf_counter()
    first = last = None
    replay_start, replay_steps = None, 0
    for chunk in range(n_chunks):
        images_k, labels_k = gen_chunk(seed, data_chunk(chunk, train_chunks), unroll, batch,
                                       palette)
        metrics = loop(state, images_k, labels_k, unroll, generator)
        first = metrics["g_loss"] if first is None else first
        last = metrics["g_loss"]
        if replay_start is not None:
            replay_steps += unroll
        elif loop.captures:
            _sync(device)
            replay_start = time.perf_counter()
        if (chunk + 1) % PROGRESS_EVERY == 0 and chunk + 1 < n_chunks:
            print(f"[ablate +{time.perf_counter() - t0:6.1f}s]   {tag} chunk "
                  f"{chunk + 1}/{n_chunks} g_loss {float(last[-1]):.4f}", flush=True)
    _sync(device)
    end = time.perf_counter()
    return {
        "final_loss": float(last[-1]),
        "first_chunk_loss": float(first.mean()), "last_chunk_loss": float(last.mean()),
        "steps": n_chunks * unroll, "eager_steps": loop.eager_steps,
        "replayed_steps": loop.replayed_steps, "captures": loop.captures,
        "capture_ms": loop.capture_ms,
        "ms_per_replayed_step": (1e3 * (end - replay_start) / replay_steps
                                 if replay_steps else None),
        "train_s": end - start,
    }


@torch.no_grad()
def evaluate(model: torch.nn.Module, palette: torch.Tensor, batch: int = BATCH,
             val_images: int = VAL_IMAGES) -> float:
    """Val mIoU over `val_images` frames in groups of `batch`: the eval fast
    path on the model in eval mode, one int64 confusion on the device, read
    once."""
    model.eval()
    val_fn = make_fast_val_batch_fn(model, (SIZE, SIZE), CLASSES, ignore_label=255)
    device = palette.device
    hs = torch.full((batch,), SIZE, dtype=torch.int64, device=device)
    conf = torch.zeros((CLASSES, CLASSES), dtype=torch.int64, device=device)
    for i in range(val_images // batch):
        images, labels = val_batch(i, batch, palette)
        conf += val_fn(images, labels, hs, hs)[1]
    mean_iu, _ = iu_from_confusion(conf.cpu().numpy())
    return float(mean_iu)


def device_line(device: torch.device) -> str:
    """The card's name and power limit as `nvidia-smi` reports them; "cpu"
    on the CPU."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", "-i", str(device.index or 0)],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def _free(device: torch.device) -> None:
    """Release a finished leg: its graph's pool, its tensors and the cuBLAS
    workspaces, so the next leg starts from the shared teacher alone. torch
    keeps a workspace per (cuBLAS handle, stream) until told to drop them,
    and each leg's loop runs on a stream of its own: without the clear,
    every leg left 64 MiB allocated (measured on the card, torch 2.11).
    torch's own CUDA leak check and CUDA-graph trees clear them the same
    way."""
    gc.collect()
    if device.type == "cuda":
        torch._C._cuda_clearCublasWorkspaces()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device: torch.device) -> Optional[int]:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _allocated(device: torch.device) -> Optional[int]:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else None


# ---- the ablation


def ablate(teacher_steps: int = 1200, arm_steps: int = 300, train_chunks: int = 0,
           seeds: Iterable[int] = (0, 1), out: str = OUT, state_dir: str = STATE_DIR,
           device="cuda", arms: Iterable[str] = ARM_NAMES, batch: int = BATCH,
           unroll: int = UNROLL, val_images: int = VAL_IMAGES) -> Tuple[dict, List[dict]]:
    """The teacher leg, then each arm × seed; returns the results (the JSON
    written to `out`) and one record per leg trained in this call."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device on this host; pass --device cpu")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    seeds = [int(s) for s in seeds]
    os.makedirs(state_dir, exist_ok=True)
    card = device_line(device)
    palette = torch.from_numpy(_palette()).to(device)
    backend = device.type
    t0 = time.perf_counter()

    def say(msg: str) -> None:
        print(f"[ablate +{time.perf_counter() - t0:6.1f}s] {msg}", flush=True)

    def leg(cfg, block, teacher, seed, tag, chunks):
        """Train and score one leg; returns its trained model and record."""
        _free(device)
        start = _allocated(device)
        state, loop, gen = build(cfg, block, teacher, seed)
        rec = train(state, loop, gen, cfg.num_steps, seed, palette, chunks, batch, tag=tag,
                    t0=t0)
        model = state.student
        del state, loop
        rec["val_mean_iu"] = evaluate(model, palette, batch, val_images)
        rec.update(leg=tag, device=card, start_allocated=start,
                   max_memory_allocated=_peak(device))
        say("leg " + json.dumps(rec))
        return model, rec

    results: dict = {
        "task": {"size": SIZE, "classes": CLASSES, "batch": batch,
                 "noise_sigma": NOISE_SIGMA, "field_res": FIELD_RES,
                 "val_images": val_images},
        "teacher_steps": teacher_steps, "arm_steps": arm_steps,
        "train_chunks": train_chunks, "seeds": seeds, "backend": backend, "device": card,
    }
    legs: List[dict] = []

    # ---- 1) the teacher: Bottleneck blocks, the task loss alone. Its leg
    # trains it as the student of a step with pi, pa and ho off, which
    # runs no teacher forward; the teacher slot holds a separate untrained
    # module (the step sets the slot's module to eval mode).
    t_tag = f"{backend}_s{teacher_steps}"
    t_ckpt = os.path.join(state_dir, f"teacher_{t_tag}.pt")
    t_meta = os.path.join(state_dir, f"teacher_{t_tag}.json")
    cfg_t = make_cfg(False, False, False, teacher_steps, device, batch, unroll)
    if os.path.exists(t_ckpt) and os.path.exists(t_meta):
        t_state = torch.load(t_ckpt, map_location=device, weights_only=True)
        with open(t_meta) as f:
            results["teacher"] = json.load(f)
        say(f"teacher resumed from {t_ckpt} (val mIoU "
            f"{results['teacher']['val_mean_iu']:.4f})")
    else:
        say(f"teacher pretrain ({teacher_steps} steps) ...")
        slot = make_model(cfg_t, BOTTLENECK, torch.Generator().manual_seed(0))
        trained, rec = leg(cfg_t, BOTTLENECK, slot, TEACHER_SEED, "teacher", 0)
        legs.append(rec)
        results["teacher"] = {"final_loss": rec["final_loss"],
                              "val_mean_iu": rec["val_mean_iu"]}
        t_state = trained.state_dict()
        torch.save({k: v.cpu() for k, v in t_state.items()}, t_ckpt)
        with open(t_meta, "w") as f:
            json.dump(results["teacher"], f)
        del slot, trained
    # the one read-only teacher of every arm and seed
    teacher = make_model(cfg_t, BOTTLENECK, torch.Generator().manual_seed(0))
    teacher.load_state_dict(t_state, strict=True)
    teacher.eval().requires_grad_(False)
    del t_state

    # ---- 2) the arms × seeds: identical inits, data and budget
    flags_of = dict(ARMS)
    tc_tag = f"_tc{train_chunks}" if train_chunks else ""
    results["arms"] = {}
    for name in arms:
        cfg = make_cfg(num_steps=arm_steps, device=device, batch=batch, unroll=unroll,
                       **flags_of[name])
        mious, losses = [], []
        for seed in seeds:
            path = os.path.join(state_dir, f"arm_{name}_{seed}_{t_tag}_a{arm_steps}{tc_tag}.json")
            if os.path.exists(path):
                with open(path) as f:
                    rec = json.load(f)
                say(f"arm {name:<9} seed {seed}: resumed val mIoU {rec['val_mean_iu']:.4f}")
            else:
                model, rec = leg(cfg, BASIC, teacher, seed, f"{name}/s{seed}", train_chunks)
                legs.append(rec)
                del model
                with open(path, "w") as f:
                    json.dump({"val_mean_iu": rec["val_mean_iu"],
                               "final_loss": rec["final_loss"]}, f)
            mious.append(rec["val_mean_iu"])
            losses.append(rec["final_loss"])
        results["arms"][name] = {
            "val_mean_iu": mious,
            "mean": float(np.mean(mious)),
            "spread": float(np.max(mious) - np.min(mious)),
            "final_loss": losses,
        }
    _free(device)

    results["wall_s"] = round(time.perf_counter() - t0, 1)
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    with open(out, "w") as f:
        json.dump(results, f, indent=2)
    print(json.dumps(results), flush=True)
    return results, legs


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="KD ablation: teacher + four arms (PyTorch/CUDA)")
    p.add_argument("--teacher-steps", default=1200, type=int)
    p.add_argument("--arm-steps", default=300, type=int)
    p.add_argument("--train-chunks", default=0, type=int,
                   help="if >0, the four arms train on a FIXED pool of this many data chunks "
                        "(UNROLL*BATCH images each), cycled as epochs; 0 = every chunk fresh")
    p.add_argument("--seeds", default="0,1", type=str)
    p.add_argument("--out", default=OUT)
    p.add_argument("--state-dir", default=STATE_DIR,
                   help="resume cache: the trained teacher and each finished (arm, seed)")
    p.add_argument("--cpu", action="store_true", help="the same as --device cpu")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device; a host without CUDA needs --device cpu")
    a = p.parse_args(argv)
    results, _ = ablate(a.teacher_steps, a.arm_steps, a.train_chunks,
                        [int(s) for s in a.seeds.split(",")], a.out, a.state_dir,
                        "cpu" if a.cpu else a.device)
    return results


if __name__ == "__main__":
    main()
