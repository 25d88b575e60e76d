"""The training cells: a closed loop of chunks through `KDTrainer.fit`.

Set-up (counted in `setup_s`): the seeded weights and the input pool on the
card (each network the file its configuration slot names, `reference/
archs.py`), the teacher's running statistics calibrated on a batch of the
pool, the trainer, then its first steps through `fit` itself, fed from the
pool: a chunk with one valid step and one with two (the start the reference
follows, eager by the loop's rule for part-filled chunks), the loop's eager
warm-up chunk, the chunk it captures, and one replay. The window feeds full
chunks of the pool, in turn, to one `fit` call until `--seconds` have
passed, and ends at a synchronize after the last chunk. After it, one more
chunk runs through `fit` as a replay for the reference to follow, the
trainer is freed, and the reference runs.

The comparison (float32 reference, TF32 off; see `checks.py`):
  * the start: each of the first three steps' G and D losses, the first
    step's gradient of every leaf (from the momentum buffer after it, less
    the weight decay), the change of every leaf over the three steps;
  * the replayed chunk, from the program's own state before it (its
    parameters, buffers, momentum buffers and the draws' generator): the
    four steps' losses and every leaf's change over the chunk.
"""

from __future__ import annotations

import itertools
import math
import os
import shutil
import tempfile
from typing import Dict

import torch

from benchmark import checks, harness, inputs
from benchmark.reference import archs, counts, kd_step, nets, precision, weights

TRAIN_STAGES = ("teacher_forward", "student_loss_and_grad", "d_loss_and_grad")


def specs_of(config: dict) -> dict:
    r, d = config["recipe"], config["disc"]
    return {"teacher": archs.spec_of(config["teacher"], r["classes"]),
            "student": archs.spec_of(config["student"], r["classes"]),
            "disc": nets.disc_spec(r["classes"], d["imsize_for_adv"], d["adv_conv_dim"])}


def train_config(config: dict, traffic: dict, device: str, tmp: str, seed: int):
    from structure_knowledge_distillation_tpu_torch.config import TrainConfig

    r, d = config["recipe"], config["disc"]
    fields = {}
    for slot in ("teacher", "student"):
        fields.update(archs.network(config[slot]["arch"]).program_fields(config[slot]))
    return TrainConfig(
        data_set=config.get("data_set", "cityscapes"), classes_num=r["classes"],
        batch_size=traffic["batch"],
        input_size=tuple(traffic["crop"]), compute_dtype=config["compute_dtype"],
        pi=r["pi"], pa=r["pa"], ho=r["ho"], adv_loss_type=r["adv_loss_type"],
        lambda_pi=r["lambda_pi"], lambda_pa=r["lambda_pa"], lambda_d=r["lambda_d"],
        lambda_gp=r["lambda_gp"], lr_g=r["lr_g"], lr_d=r["lr_d"], momentum=r["momentum"],
        weight_decay=r["weight_decay"], power=r["power"], num_steps=r["num_steps"],
        imsize_for_adv=d["imsize_for_adv"], adv_conv_dim=d["adv_conv_dim"],
        preprocess_gan_mode=d["preprocess_gan_mode"], **fields,
        unroll_steps=traffic["unroll"], log_every=traffic["log_every"],
        device=device, seed=seed % (2 ** 31),
        log_path=os.path.join(tmp, "log"), snapshot_dir=os.path.join(tmp, "snapshots"),
        S_ckpt_path=os.path.join(tmp, "ckpt"))


class Pool:
    """`pool_chunks` distinct chunks of `unroll` batches, made on the card
    from the seed: images in the wire's type (the compute type), uint8
    labels, as `Chunk`s; `f32(i, k)` is the batch of step k of chunk i as
    the reference gets it."""

    def __init__(self, traffic: dict, classes: int, seed: int, device, dtype):
        from structure_knowledge_distillation_tpu_torch.data.prefetch import Chunk

        q, k, n = traffic["pool_chunks"], traffic["unroll"], traffic["batch"]
        crop = tuple(traffic["crop"])
        gen = inputs.make_generator(device, seed, 2)
        self.images, self.labels, self.chunks = [], [], []
        valid = 0
        for _ in range(q):
            img = inputs.images(gen, k * n, crop, traffic, device).to(dtype).view(k, n, 3, *crop)
            lab = inputs.labels(gen, k * n, crop, classes, traffic, device).view(k, n, *crop)
            valid += int((lab != 255).sum())
            self.chunks.append(Chunk(img, lab, k))
            self.images.append(img)
            self.labels.append(lab)
        self.valid_pixels = valid / (q * k)

    def part(self, i: int, n_valid: int):
        from structure_knowledge_distillation_tpu_torch.data.prefetch import Chunk

        c = self.chunks[i % len(self.chunks)]
        return Chunk(c.images, c.labels, n_valid)

    def f32(self, i: int, k: int, device=None):
        i %= len(self.images)
        x, y = self.images[i][k], self.labels[i][k]
        if device is not None:
            x, y = x.to(device), y.to(device)
        return x.float(), y.long()


def _named(module) -> Dict[str, torch.Tensor]:
    return {k: v.detach().clone() for k, v in module.state_dict().items()}


def _buffers(opt, module) -> Dict[str, torch.Tensor]:
    out = {}
    for name, p in module.named_parameters():
        st = opt.state.get(p, {})
        if st.get("momentum_buffer") is not None:
            out[name] = st["momentum_buffer"].detach().clone()
    return out


def _to(d: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device) for k, v in d.items()}


def snapshot(trainer, device="cpu") -> dict:
    """The train state as the reference takes it: every tensor of student and
    D, both momentum sets, the step and the draws' generator."""
    return {"student": _to(_named(trainer.student), device),
            "disc": _to(_named(trainer.discriminator), device),
            "g_buf": _to(_buffers(trainer.state.g_opt, trainer.student), device),
            "d_buf": _to(_buffers(trainer.state.d_opt, trainer.discriminator), device),
            "step": trainer.state.step, "generator": trainer.generator.get_state()}


def _losses(history, n: int):
    return [m for _, m in history[-n:]]


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_origin: float = 0.0, control: bool = False) -> dict:
    """Set-up, window and check of one run; returns the harness's record."""
    from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

    dev = torch.device(device)
    config, traffic = cell.config, cell.traffic
    recipe = kd_step.Recipe(config["recipe"])
    specs = specs_of(config)
    dtype = torch.bfloat16 if config["compute_dtype"] == "bfloat16" else torch.float32
    wgen = inputs.make_generator(dev, seed, 1)
    state0 = {k: weights.make_state(specs[k], wgen, dev) for k in ("teacher", "student", "disc")}
    pool = Pool(traffic, recipe.classes, seed, dev, dtype)
    calib = inputs.images(inputs.make_generator(dev, seed, 4), traffic["batch"],
                          tuple(traffic["crop"]), traffic, dev)
    weights.calibrate(specs["teacher"], state0["teacher"], calib)
    del calib
    unroll = traffic["unroll"]
    # spans from before the trainer is built, so its capture holds the marks
    recorder = harness.start_spans() if trace and harness.wants_spans(cell) else None
    span_record = None
    tmp = tempfile.mkdtemp(prefix="bench_train_")
    try:
        cfg = train_config(config, traffic, dev.type, tmp, seed)
        trainer = KDTrainer(cfg, teacher_state=state0["teacher"],
                            student_state=state0["student"], d_state=state0["disc"])
        draw_seed = seed % (2 ** 63 - 1)
        trainer.generator.manual_seed(draw_seed)
        state0 = {k: _to(v, "cpu") for k, v in state0.items()}
        if trace:
            harness.warm_profiler(dev)
        # the memory the job needs: from its first step on, the capture's
        # pool included (a replay allocates nothing of its own)
        harness.reset_peak(dev)
        # the start: steps 1, then 2 and 3, every step logged
        cfg.log_every = 1
        trainer.fit([pool.part(0, 1)])
        after1 = {"g_buf": _to(_buffers(trainer.state.g_opt, trainer.student), "cpu"),
                  "d_buf": _to(_buffers(trainer.state.d_opt, trainer.discriminator), "cpu"),
                  "stats": {k: v.cpu() for k, v in _named(trainer.student).items()
                            if k.endswith("running_var")}}
        trainer.fit([pool.part(1, 2)])
        after3 = snapshot(trainer)
        start_losses = _losses(trainer.history, 3)
        cfg.log_every = traffic["log_every"]
        # the loop's eager warm-up chunk, its capture, one replay
        trainer.fit([pool.part(i, unroll) for i in (2, 3, 0)])
        harness.sync(dev)
        loop = trainer.train_loop
        capture_ms, replays0 = loop.capture_ms, loop.replays
        fed, prof_box = [0], {}

        def feed():
            for i in itertools.count():
                if harness.now() - t0 >= seconds:
                    return
                if trace:
                    _trace_hook(prof_box, i, traffic, dev)
                fed[0] += 1
                yield pool.chunks[(i + 1) % len(pool.chunks)]

        t0 = harness.now()
        trainer.fit(feed())
        harness.sync(dev)
        window_s = harness.now() - t0
        if "prof" in prof_box:
            _stop(prof_box, dev, fed[0] - traffic["trace_from"])
        if recorder is not None:
            span_record, recorder = recorder.stop(), None
        steps = fed[0] * unroll
        peak = harness.peak_bytes(dev)
        replays = loop.replays - replays0
        # the replayed chunk the reference follows, from the program's state
        k_check = fed[0] + 1
        before = snapshot(trainer)
        cfg.log_every = 1
        trainer.fit([pool.part(k_check, unroll)])
        check_replayed = loop.replays - replays0 - replays == 1
        after = snapshot(trainer)
        replay_losses = _losses(trainer.history, unroll)
        window_losses = [m for _, m in trainer.history]
        del trainer, loop
    finally:
        if recorder is not None:  # unwinding from an error
            recorder.stop(read_marks=False)
        shutil.rmtree(tmp, ignore_errors=True)
    harness.free_cache(dev)
    record = {"steps": steps, "window_s": window_s, "setup_s": t0 - t_origin, "peak": peak,
              "capture_ms": capture_ms, "replays": replays,
              "images": steps * traffic["batch"], "valid_pixels": pool.valid_pixels,
              "crop": tuple(traffic["crop"]), "trace": None, "spans": span_record}
    if "stopped" in prof_box:
        prof, wall, n = prof_box.pop("stopped")
        record["trace"] = harness.Trace.from_profiler(prof, wall, TRAIN_STAGES, steps=n)
    precision.exact_f32()
    numbers = checks.train_numbers(
        specs, recipe, state0, after1, after3, start_losses, before, after, replay_losses,
        pool, k_check, unroll, draw_seed, dev, control=control)
    if dev.type == "cuda" and not check_replayed:
        # on the card a full chunk after the capture is a replay: a check
        # chunk that was not one checked another path
        numbers["replay_loss_gap"] = numbers["replay_update_gap"] = math.inf
    record["finite"] = all(all(math.isfinite(v) for v in m.values()) for m in window_losses)
    numbers["terms.window_finite"] = record["finite"]
    numbers["terms.replays"] = replays
    record["numbers"] = numbers
    if trace:
        record.update(counts.train_step_counts(specs, recipe, traffic["batch"],
                                               tuple(traffic["crop"])))
    return record


def _trace_hook(box: dict, i: int, traffic: dict, dev) -> None:
    """Profile chunks [trace_from, trace_from + trace_chunks) of the window:
    start after a synchronize, stop (at the next chunk) after another."""
    first, n = traffic["trace_from"], traffic["trace_chunks"]
    if i == first:
        harness.sync(dev)
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        box["prof"] = torch.profiler.profile(activities=acts)
        box["prof"].start()
        box["t0"] = harness.now()
        box["unroll"] = traffic["unroll"]
    elif i == first + n and "prof" in box:
        _stop(box, dev, n)


def _stop(box: dict, dev, chunks: int) -> None:
    harness.sync(dev)
    wall = harness.now() - box["t0"]
    prof = box.pop("prof")
    prof.stop()
    # the events are read after the window
    box["stopped"] = (prof, wall, chunks * box["unroll"])
