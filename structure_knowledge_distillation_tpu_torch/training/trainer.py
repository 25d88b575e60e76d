"""KDTrainer — builds the models and optimizers, runs the train step, evaluates
and checkpoints.

Counterpart of `structure_knowledge_distillation_tpu/training/trainer.py`
(reference networks/kd_model.py `NetModel` + the loop of
train_and_eval.py:20-30): model and state construction from a `TrainConfig`
(`last_step` offsets `state.step`), the per-step loop with metric logging
every `log_every` steps (to the log and, with `log_path`, to
`<log_path>/scalars.jsonl`), the reference's `should_eval` cadence through
the ported `evaluate_main` with a checkpoint at every eval, resume, and a
graceful stop on SIGTERM.

Checkpoints, all torch files, written synchronously (`training/checkpoint.py`):
  * `<snapshot_dir>/CS_scenes_{step}_{mIoU}.pth` (+ `.json` meta): the
    student's state dict alone, the reference's cadence snapshot;
  * `<S_ckpt_path>/model_best.pth.tar` (or in `snapshot_dir` when
    `S_ckpt_path` is empty) at each new best: the reference's rich
    checkpoint (`state_dict`, `step`, `best_mean_IU`) with the full train
    state beside it (`discriminator`, `g_opt`, `d_opt`, `generator`,
    `state_step`). The JAX package's `load_torch_checkpoint` reads it, and
    its `resume_from_snapshot` takes the student's weights from it;
  * `<snapshot_dir>/latest/step_{n}.pth`: the same full state at every eval
    and at a preemption, the newest 3 kept (the JAX package's Orbax
    directory); `try_resume` restores the newest.

A full state restores a run exactly: the student and D (spectral-norm u/v
and BatchNorm statistics included), both momentum buffers, `state.step` and
the `torch.Generator` of the dropout masks and the GP α.

With `unroll_steps > 1` the loop runs chunks of that many steps through
`make_train_loop` (one CUDA-graph replay per full chunk on the card), as the
JAX trainer runs its scanned loop: `Chunk`s from `data.chunk_batches` pass
through, per-step batches are stacked here, logging reads each logged
chunk's stacked metrics once, an eval that falls inside a chunk runs after
it under the hit's step with the checkpoint's `state_step` at the chunk's
end, and SIGTERM is answered at the chunk boundary. `profile_dir` traces
steps [first + 9, first + 9 + profile_steps) of the run with
`torch.profiler` (CPU and, on the card, CUDA activities), starting and
stopping at chunk boundaries, into a trace file in `profile_dir`.

With `num_data_shards` N > 1 the trainer is one rank of N (the JAX trainer
on a `data` mesh, trainer.py:116-145): it joins the process group (the
launcher's, `parallel.launch`, or one formed from a launcher's environment,
`parallel.join_group`), puts its models on `cuda:<rank>` (NCCL) or the CPU
(gloo), syncs the ABNs of the student and of D's `preprocess_additional`
over the group (the teacher runs in eval mode), and broadcasts rank 0's
initial or resumed state (student and D parameters and buffers, spectral
u/v included, the momentum buffers and the generator of the draws). Each
rank trains on its slice of every global batch through the data-parallel
step, and the in-training eval runs sharded (`evaluate_sharded` with the
group; the val loader yields this rank's frames, `data.EvalShard`), as the
JAX trainer's does (trainer.py:478-495). Rank 0 alone logs, writes the
metrics and the checkpoints, with a barrier after each save; every rank
resumes from the same file. A SIGTERM on any rank stops every rank at the
same step (or chunk) boundary: the flag is all-reduced on the host at each
boundary, and rank 0 writes the one `latest/` save. Checkpoints have the
one-card format: a file from an N-rank run resumes a one-card run, and the
other way round.
"""

from __future__ import annotations

import itertools
import logging
import os
import signal
import threading
import time
from typing import Iterable, Iterator, Mapping, Optional

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data.prefetch import Chunk, chunk_batches, to_nchw
from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ESPNetC, ResPSPNet
from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import set_process_group
from structure_knowledge_distillation_tpu_torch.parallel.data_parallel import (
    any_rank,
    broadcast_state,
    host_barrier,
    host_group,
    join_group,
    rank_device,
    world_of,
)
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt
from structure_knowledge_distillation_tpu_torch.training.checkpoint import (
    load_reference_state_dict,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    evaluate_main,
    evaluate_sharded,
)
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)
from structure_knowledge_distillation_tpu_torch.utils import MetricsWriter

__all__ = ["KDTrainer"]

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _enumerate_steps(chunks: Iterable[Chunk], first_step: int) -> Iterator[tuple]:
    """Pair each Chunk with the global index of its first (valid) step."""
    step = first_step
    for chunk in chunks:
        yield step, chunk
        step += chunk.n_valid


def _as_tensors(state_dict: Mapping) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            for k, v in state_dict.items()}


class KDTrainer:
    """Teacher, student and discriminator on `cfg.device`, with their optimizers.

    The student is the R18 `ResPSPNet` (with `cfg.remat`, its residual
    blocks rematerialised) or, with `cfg.student_arch == "espnet"`, the
    ESPNet-C `ESPNetC` (p=2, q=8), whose state-dict keys are the port's own.
    `teacher_state`, `student_state` and `d_state` are state dicts under the
    reference's torch names (a released `.pth`, or the JAX package's
    `export_torch_*`). A missing teacher is all zeros, with the JAX trainer's
    warning; a missing student or discriminator keeps its seeded random
    init, drawn from `torch.Generator().manual_seed(cfg.seed)` (student
    first, then D). The same generator then draws the dropout masks and the
    GP α of every step. With `cfg.num_data_shards` > 1, one rank of the
    data-parallel run (see the module's docstring); `group`, `rank` and
    `world` say which."""

    def __init__(self, cfg: TrainConfig, teacher_state: Optional[Mapping] = None,
                 student_state: Optional[Mapping] = None, d_state: Optional[Mapping] = None):
        self.cfg = cfg
        if torch.device(cfg.device).type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device on this host; pass --device cpu")
        self.group = join_group(cfg.num_data_shards, cfg.device)
        self.rank, self.world = world_of(self.group)
        # flags, barriers and the generator's state travel on the host
        self.host_group = None if self.group is None else host_group(self.group)
        device = rank_device(cfg.device, self.group)
        self.device = device
        dtype = _DTYPES[cfg.compute_dtype]

        self.teacher = ResPSPNet(BOTTLENECK, tuple(cfg.teacher_layers), cfg.classes_num,
                                 device=device, dtype=dtype,
                                 generator=torch.Generator().manual_seed(cfg.seed))
        if teacher_state is None:
            with torch.no_grad():
                for t in list(self.teacher.parameters()) + list(self.teacher.buffers()):
                    t.zero_()
            log.warning("teacher initialized with zeros — load a real checkpoint "
                        "for distillation (cfg.T_ckpt_path)")
        else:
            load_reference_state_dict(self.teacher, teacher_state)
        self.teacher.requires_grad_(False)

        self.generator = torch.Generator().manual_seed(cfg.seed)
        if cfg.student_arch == "espnet":
            if cfg.remat:
                log.warning("--remat only applies to the ResPSPNet student; "
                            "ESPNet-C is shallow enough not to need it")
            self.student = ESPNetC(cfg.classes_num, device=device, dtype=dtype,
                                   generator=self.generator)
        else:
            self.student = ResPSPNet(BASIC, (2, 2, 2, 2), cfg.classes_num, device=device,
                                     dtype=dtype, generator=self.generator, remat=cfg.remat)
        if student_state is not None:
            load_reference_state_dict(self.student, student_state)
        self.discriminator = Discriminator(
            cfg.classes_num, preprocess_mode=cfg.preprocess_gan_mode,
            image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim, dtype=dtype,
            device=device, generator=self.generator)
        if d_state is not None:
            self.discriminator.load_state_dict(_as_tensors(d_state), strict=True)
        if self.group is not None:
            set_process_group(self.student, self.group)
            set_process_group(self.discriminator, self.group)

        self.state = KDTrainState(
            teacher=self.teacher, student=self.student, discriminator=self.discriminator,
            g_opt=make_sgd(self.student.parameters(), cfg.lr_g, cfg.momentum,
                           cfg.weight_decay),
            d_opt=make_sgd(self.discriminator.parameters(), cfg.lr_d, cfg.momentum,
                           cfg.weight_decay),
            g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
            d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power),
            step=cfg.last_step,
        )
        self.train_step = make_train_step(cfg, self.group)
        self.unroll = cfg.unroll_steps
        # the chunk loop captures its CUDA graph lazily, at the first full
        # chunk of `fit` after the eager one, so never before a resume
        self.train_loop = (make_train_loop(cfg, self.unroll, self.group) if self.unroll > 1
                           else None)
        # (step, {metric: float}) at every logged step
        self.history: list = []
        # the best val mean IU so far: the config's, raised by resume and eval
        self.best_mean_iu = cfg.best_mean_IU
        self._preempt_requested = False
        self._broadcast_state()

    # ------------------------------------------------------------- ranks
    def _broadcast_state(self) -> None:
        """Make every rank hold rank 0's train state: the student's and D's
        parameters and buffers (spectral u/v among them), the momentum
        buffers that exist, and the generator of the draws."""
        if self.group is None:
            return
        tensors = []
        for module in (self.student, self.discriminator):
            tensors += list(module.parameters()) + list(module.buffers())
        for opt in (self.state.g_opt, self.state.d_opt):
            tensors += [s["momentum_buffer"] for s in opt.state.values()
                        if s.get("momentum_buffer") is not None]
        broadcast_state(tensors, self.group)
        gen = self.generator.get_state()
        broadcast_state([gen], self.host_group)
        self.generator.set_state(gen)

    def _saved(self) -> None:
        """After rank 0's save: every rank waits until the file is whole."""
        if self.group is not None:
            host_barrier(self.host_group)

    # ------------------------------------------------------------------ train
    def fit(self, train_iter: Iterable, val_loader=None, eval_out_size=(1024, 2048)) -> float:
        """One train step per batch of `train_iter`: host numpy batches
        (images NHWC, labels NHW, ...), which are copied to `cfg.device`
        here, or batches already there from `data.device_prefetch` (images
        NCHW); with `unroll_steps > 1`, `Chunk`s of either kind, or per-step
        batches that are stacked here. Logs every `log_every` steps,
        evaluates and checkpoints on the `should_eval` cadence, and returns
        the best val mean IU.

        On the main thread a SIGTERM handler is installed for the call: the
        step (or chunk) in flight finishes, the full state is saved to the
        auto-resume stream, `fit` returns, and the previous handler is back.
        Rerun with `--S_resume true` and the same `snapshot_dir` to
        continue."""
        cfg = self.cfg
        writer = MetricsWriter(cfg.log_path) if cfg.log_path and self.rank == 0 else None
        self._preempt_requested = False
        on_main = threading.current_thread() is threading.main_thread()
        prev = signal.signal(signal.SIGTERM, self._on_sigterm) if on_main else None
        try:
            return self._fit_loop(train_iter, val_loader, eval_out_size, writer)
        finally:
            if on_main:
                signal.signal(signal.SIGTERM, prev if prev is not None else signal.SIG_DFL)
            if writer is not None:
                writer.close()

    def _on_sigterm(self, signum, frame) -> None:
        self._preempt_requested = True
        log.info("SIGTERM: checkpointing at the next step boundary")

    def _on_device(self, batch) -> tuple:
        images, labels = batch[0], batch[1]
        if not isinstance(images, torch.Tensor):  # a host batch or chunk, NHWC
            images = to_nchw(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))
            labels = torch.from_numpy(np.asarray(labels)).to(self.device)
        return images, labels

    def _chunks(self, train_iter: Iterable) -> Iterator[Chunk]:
        """`Chunk`s of `unroll` steps: Chunks pass through, per-step batches
        are stacked (the tail padded, `n_valid` marking its real steps)."""
        it = iter(train_iter)
        first = next(it, None)
        if first is None:
            return iter(())
        it = itertools.chain([first], it)
        return it if isinstance(first, Chunk) else chunk_batches(it, self.unroll)

    def _groups(self, train_iter: Iterable, first_step: int) -> Iterator[tuple]:
        """(first step, n_valid, batch or Chunk): per step when unroll is 1,
        else per chunk."""
        if self.train_loop is None:
            for step, batch in enumerate(train_iter, first_step):
                yield step, 1, batch
        else:
            for start, chunk in _enumerate_steps(self._chunks(train_iter), first_step):
                yield start, chunk.n_valid, chunk

    def _train(self, batch, n_valid: int) -> dict:
        """Train a batch or a chunk; its metrics stacked to (unroll,)."""
        images, labels = self._on_device(batch)
        if self.train_loop is None:
            metrics = self.train_step(self.state, images, labels, self.generator)
            return {k: v[None] for k, v in metrics.items()}
        return self.train_loop(self.state, images, labels, n_valid, self.generator)

    def _start_profiler(self, profile_dir: str):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(
            activities=activities,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(profile_dir))
        prof.start()
        return prof

    def _fit_loop(self, train_iter, val_loader, eval_out_size, writer) -> float:
        cfg = self.cfg
        t_last = time.time()
        steps_since_log = 0
        first_step = self.state.step + 1
        # the profile window is relative to this run's first step, so a
        # resumed run still writes a trace
        profile_start = first_step + 9
        profile_end = profile_start + cfg.profile_steps  # exclusive
        profile_dir, prof = (cfg.profile_dir if self.rank == 0 else ""), None
        try:
            for start, n_valid, batch in self._groups(train_iter, first_step):
                end = start + n_valid - 1
                if profile_dir and prof is None and start <= profile_start <= end:
                    prof = self._start_profiler(profile_dir)
                metrics_k = self._train(batch, n_valid)
                steps_since_log += n_valid
                if prof is not None and end >= profile_end - 1:
                    if self.device.type == "cuda":
                        torch.cuda.synchronize(self.device)
                    prof.stop()
                    prof = None
                    log.info("profiler trace of steps %d-%d written to %s", profile_start,
                             end, profile_dir)
                    profile_dir = ""  # one window per run, as in the JAX trainer

                log_hits = [s for s in range(start, end + 1) if s % cfg.log_every == 0]
                if log_hits and self.rank == 0:
                    ms = {k: v[:n_valid].tolist() for k, v in metrics_k.items()}
                    dt = time.time() - t_last
                    ips = steps_since_log * cfg.batch_size / max(dt, 1e-9)
                    t_last = time.time()
                    steps_since_log = 0
                    for step in log_hits:
                        m = {k: v[step - start] for k, v in ms.items()}
                        g_lr = self.state.g_sched(step)
                        log.info("step:%5d G_lr:%.6f G_loss:%.5f (mc:%.5f pi:%.5f pa:%.5f) "
                                 "D_lr:%.6f D_loss:%.5f img/s:%.2f",
                                 step, g_lr, m["g_loss"], m["mc_loss"],
                                 m.get("pi_loss", 0.0), m.get("pa_loss", 0.0),
                                 self.state.d_sched(step), m["d_loss"], ips)
                        self.history.append((step, m))
                        if writer is not None:
                            writer.write(step, {**m, "img_per_sec": ips, "g_lr": g_lr})

                eval_hits = [s for s in range(start, end + 1) if cfg.should_eval(s)]
                if val_loader is not None and eval_hits:
                    # with unroll > 1 the eval state is the chunk's end (up to
                    # unroll - 1 steps after the hit); the files keep the hit
                    step = eval_hits[-1]
                    loader = val_loader() if callable(val_loader) else val_loader
                    mean_iu, iu_array = self.evaluate(loader, eval_out_size)
                    is_best = mean_iu > self.best_mean_iu
                    self.best_mean_iu = max(self.best_mean_iu, mean_iu)
                    if self.rank == 0:
                        log.info("[val] step %d mean_IU: %.6f IU_array: %s", step, mean_iu,
                                 np.array2string(iu_array, precision=4))
                        if writer is not None:
                            writer.write(step, {"val_mean_iu": mean_iu})
                        self.save_checkpoint(step, mean_iu, is_best=is_best, state_step=end)
                    self._saved()

                preempted = self._preempt_requested
                if self.group is not None:
                    preempted = any_rank(preempted, self.host_group)
                if preempted:
                    if self.rank == 0:
                        path = ckpt.save_auto_resume(self._auto_resume_dir,
                                                     self.full_state(end, self.best_mean_iu, end),
                                                     end)
                        log.info("preempted: full state saved at step %d to %s; rerun with "
                                 "--S_resume true and the same snapshot_dir to resume", end,
                                 path)
                    self._saved()
                    break
        finally:
            if prof is not None:
                prof.stop()
        if self.train_loop is not None and self.rank == 0:
            lp = self.train_loop
            log.info("multi-step loop: %d steps in %d CUDA-graph replays (%d captures), "
                     "%d steps eager", lp.replayed_steps, lp.replays, lp.captures,
                     lp.eager_steps)
        return self.best_mean_iu

    def evaluate(self, val_loader: Iterable, out_size=(1024, 2048)):
        """The student's whole-image val sweep; returns (mean_IU, IU_array).

        As the JAX trainer's: the frames cross on the u8 image wire unless
        `wire_format` is f32, for Cityscapes and CamVid, whose unscaled,
        unpadded val frames are integer−mean (synthetic images are not, so
        they keep the f32 wire); `cfg.scales`/`cfg.flip` select the
        multiscale+flip sweep. With a process group the sweep is sharded:
        `val_loader` yields this rank's frames (`data.EvalShard` over the
        val set, one frame a rank per group), and the confusion is
        all-reduced, so every rank returns the same mIoU."""
        cfg = self.cfg
        input_mean = None
        if cfg.wire_format != "f32" and cfg.data_set in ("cityscapes", "cityscape", "camvid"):
            input_mean = np.asarray(cfg.input_mean_bgr, np.float32)
        self.student.eval()
        common = dict(out_size=tuple(out_size), scales=tuple(cfg.scales) or (1.0,),
                      flip=bool(cfg.flip), ignore_label=cfg.ignore_label,
                      input_mean=input_mean, device=self.device)
        try:
            if self.group is not None:
                mean_iu, iu_array, _ = evaluate_sharded(
                    self.student, val_loader, cfg.classes_num, batch=self.world,
                    group=self.group, **common)
            else:
                mean_iu, iu_array, _ = evaluate_main(self.student, val_loader, cfg.classes_num,
                                                     **common)
        finally:
            self.student.train()
        return mean_iu, iu_array

    # ------------------------------------------------------------ checkpoints
    @property
    def _auto_resume_dir(self) -> str:
        return os.path.join(self.cfg.snapshot_dir, "latest")

    def full_state(self, step: int, best_mean_iu: float, state_step: int) -> dict:
        """The reference's rich checkpoint (`state_dict` = the student, `step`,
        `best_mean_IU`) with the rest of the train state beside it;
        `state_step` is the step the state is at, which a resume restores."""
        return {"state_dict": self.student.state_dict(), "step": int(step),
                "best_mean_IU": float(best_mean_iu),
                "discriminator": self.discriminator.state_dict(),
                "g_opt": self.state.g_opt.state_dict(), "d_opt": self.state.d_opt.state_dict(),
                "generator": self.generator.get_state(), "state_step": int(state_step)}

    def save_checkpoint(self, step: int, mean_iu: float, is_best: bool = False,
                        state_step: Optional[int] = None) -> str:
        """At an eval: the cadence snapshot, the `model_best.pth.tar` copy when
        `is_best`, and the auto-resume file. `step` names the files (the
        reference's convention, kd_model.py:192); `state_step` (default
        `state.step`, the only value the per-step loop passes) is the step
        the saved state is at: recorded in every file and restored by a
        resume. Returns the snapshot's path."""
        cfg = self.cfg
        state_step = int(self.state.step if state_step is None else state_step)
        path = os.path.join(cfg.snapshot_dir, f"CS_scenes_{step}_{mean_iu}")
        snapshot = ckpt.save_student_snapshot(path, self.student.state_dict(), step=step,
                                              mean_iu=mean_iu, state_step=state_step)
        if is_best:
            best_dir = cfg.S_ckpt_path or cfg.snapshot_dir
            ckpt.save_torch(self.full_state(step, mean_iu, state_step),
                            os.path.join(best_dir, "model_best.pth.tar"))
        ckpt.save_auto_resume(
            self._auto_resume_dir,
            self.full_state(state_step, max(self.best_mean_iu, mean_iu), state_step), state_step)
        return snapshot

    def resume_from_snapshot(self, path: str) -> int:
        """Resume from an explicit checkpoint; returns the restored step.

        A file with the full train state (the port's `model_best.pth.tar`, an
        auto-resume file) restores the run exactly. A reference-style
        `.pth[.tar]` (a `state_dict` with `step` / `best_mean_IU`, or a bare
        state dict with a `.json` sidecar, as `CS_scenes_*.pth`) is a
        weights-only resume, as in the JAX package: the student's weights,
        the step (and so the lr), the best mean IU; momentum restarts and D
        keeps its weights."""
        sd, meta = ckpt.load_torch_checkpoint(path)
        if "discriminator" in meta:
            self.student.load_state_dict(sd)
            self.discriminator.load_state_dict(meta["discriminator"])
            self.state.g_opt.load_state_dict(meta["g_opt"])
            self.state.d_opt.load_state_dict(meta["d_opt"])
            self.generator.set_state(meta["generator"])
            self.state.step = int(meta["state_step"])
        else:
            load_reference_state_dict(self.student, sd)
            if not meta and os.path.isfile(os.path.splitext(path)[0] + ".json"):
                meta = ckpt.load_meta(path)
            self.state.step = int(meta.get("state_step", meta.get("step")) or 0)
        best = float(meta.get("best_mean_IU", meta.get("mean_iu")) or 0.0)
        self.best_mean_iu = max(self.best_mean_iu, best)
        self._broadcast_state()
        log.info("resumed from %s (step %d, best_mean_IU %.4f)", path, self.state.step, best)
        return self.state.step

    def try_resume(self) -> int:
        """Restore the newest file of the auto-resume stream (after a crash or
        a preemption); returns its step, 0 if there is none."""
        path = ckpt.latest_auto_resume(self._auto_resume_dir)
        return 0 if path is None else self.resume_from_snapshot(path)
