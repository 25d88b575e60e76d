"""The val-sweep cells: frames through `evaluate_main`'s fast path.

Set-up (counted in `setup_s`): the student's seeded weights on the card,
its running statistics calibrated on a frame of the pool, the pool of
distinct host frames and labels made from the seed (on the card, then
copied to the host as the loader would hand them over), the model the
student's network file serves (`networks/<arch>.py`, as `cli/eval.py`
builds it), and a sweep of `warmup_frames` frames. The window is one
`evaluate_main` call over a loader that hands out the pool's frames in turn
until `--seconds` have passed; it ends when the confusion is back on the
host.

The comparison. After the window, one more sweep through `evaluate_main`
over every frame of the pool, one frame a call, with `output_dir` set: the
class map of each frame comes back as the PNG that the program writes, with
that frame's confusion. Then:
  * `window_check_diff`: Σ|window's confusion − Σ_frames (times the window
    scored the frame) · the check sweep's confusion of the frame|, exact
    (limit 0): the window's answers are those of the check sweep;
  * `logit_gap`: the widest gap, over every pixel of every pool frame, by
    which the reference's logit (float32 forward, TF32 off, align-corners
    upsample) of the program's class lies below the reference's best, in
    units of the reference logits' standard deviation. A pixel whose two
    best classes nearly tie can flip on rounding with a gap near 0; a wrong
    answer has a gap of the order of 1.
`class_mismatch_share` (a reading, not compared, with `--control` only):
Σ|window's confusion − the reference's| / (2 · pixels counted), at least the
share of pixels whose class differs.
"""

from __future__ import annotations


import os
import shutil
import tempfile

import numpy as np
import torch
import torch.nn.functional as F

from benchmark import harness, inputs
from benchmark.reference import archs, counts, nets, precision, weights

EVAL_STAGES = ()


def spec_of(config: dict) -> dict:
    return archs.spec_of(config["student"], config["recipe"]["classes"])


def _confusion(pred: torch.Tensor, lab: torch.Tensor, classes: int) -> torch.Tensor:
    valid = lab != 255
    idx = (lab[valid] * classes + pred[valid]).reshape(-1)
    return torch.bincount(idx, minlength=classes * classes).reshape(classes, classes).cpu()


def reference_sweep(spec, state, frames, labels, classes, prec, dev, served=None) -> dict:
    """Per frame: the reference's confusion and class map; with `served`
    (the program's class map of each frame), the widest logit gap of the
    served classes, in units of the reference logits' standard deviation."""
    confs, maps, gap = [], [], 0.0
    with torch.no_grad():
        for i, (x, y) in enumerate(zip(frames, labels)):
            xd = torch.from_numpy(x).to(dev).permute(0, 3, 1, 2).float()
            logits = archs.forward(nets.Ctx(state, prec, False), spec, xd)[0]
            up = F.interpolate(logits, size=y.shape[1:], mode="bilinear", align_corners=True)
            pred = up.argmax(1)
            confs.append(_confusion(pred, torch.from_numpy(y).to(dev).long(), classes))
            maps.append(pred.to(torch.uint8).cpu().numpy())
            if served is not None:
                s = torch.from_numpy(served[i]).to(dev).long().reshape(pred.shape)
                best = up.amax(1)
                got = up.gather(1, s[:, None])[:, 0]
                gap = max(gap, float((best - got).max() / up.std()))
            del logits, up
    return {"confusions": confs, "maps": maps, "gap": gap}


def _read_png(path: str) -> np.ndarray:
    from PIL import Image

    with Image.open(path) as im:
        return np.array(im, dtype=np.uint8)


def mismatch_share(conf_prog: np.ndarray, conf_ref: np.ndarray) -> float:
    total = conf_ref.sum()
    if conf_prog.shape != conf_ref.shape or conf_prog.sum() != total or total == 0:
        return float("inf")
    return float(np.abs(conf_prog.astype(np.int64) - conf_ref).sum() / (2 * total))


def run(cell: harness.Cell, seed: int, seconds: float, trace: bool, device: str = "cuda",
        t_origin: float = 0.0, control: bool = False) -> dict:
    from structure_knowledge_distillation_tpu_torch.training.checkpoint import (
        load_reference_state_dict,
    )
    from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main

    config, traffic = cell.config, cell.traffic
    classes = config["recipe"]["classes"]
    spec = spec_of(config)
    dev = torch.device(device)
    frame = tuple(traffic["frame"])
    gen = inputs.make_generator(dev, seed, 3)
    state = weights.make_state(spec, inputs.make_generator(dev, seed, 1), dev)
    n_pool = traffic["pool_frames"]
    frames, labels = [], []
    for _ in range(n_pool):
        img = inputs.images(gen, 1, frame, traffic, dev)
        if not frames:
            weights.calibrate(spec, state, img)
        frames.append(img.permute(0, 2, 3, 1).contiguous().cpu().numpy())
        labels.append(inputs.labels(gen, 1, frame, classes, traffic, dev).cpu().numpy())
    model = archs.network(config["student"]["arch"]).served(config["student"], classes, dev)
    load_reference_state_dict(model, state)
    model.eval()
    state = {k: v.cpu() for k, v in state.items()}
    sizes = np.array([[frame[0], frame[1], 3]])
    counts_seen = np.zeros(n_pool, np.int64)

    def loader(limit_s=None, first=0, n=None, t0=None, prof_box=None):
        for i in range(first, first + (n if n is not None else 1 << 60)):
            if limit_s is not None and harness.now() - t0 >= limit_s:
                return
            if prof_box is not None:
                _trace_hook(prof_box, i - first, traffic, dev)
            j = i % n_pool
            if limit_s is not None:
                counts_seen[j] += 1
            yield frames[j], labels[j], sizes, [f"frame_{j}"]

    common = dict(out_size=frame, device=dev)
    if trace:
        harness.warm_profiler(dev)
    harness.reset_peak(dev)
    evaluate_main(model, loader(n=traffic["warmup_frames"]), classes, **common)
    harness.sync(dev)
    # spans of the window's frames alone: the sweep captures nothing that
    # needs marks from set-up
    recorder = harness.start_spans() if trace and harness.wants_spans(cell) else None
    setup_s = harness.now() - t_origin
    box = {} if trace else None
    span_record = None
    try:
        t0 = harness.now()
        _, _, conf = evaluate_main(model, loader(seconds, 0, None, t0, box), classes, **common)
        window_s = harness.now() - t0
        if box and "prof" in box:
            _stop(box, dev, int(counts_seen.sum()) - traffic["trace_from"])
        if recorder is not None:
            span_record, recorder = recorder.stop(), None
    finally:
        if recorder is not None:  # unwinding from an error
            recorder.stop(read_marks=False)
    peak = harness.peak_bytes(dev)
    frames_scored = int(counts_seen.sum())
    # the check sweep: each pool frame once more, its class map as a PNG
    served, check_confs = [], []
    out_dir = tempfile.mkdtemp(prefix="bench_eval_")
    try:
        for j in range(n_pool):
            _, _, c = evaluate_main(model, loader(first=j, n=1), classes, output_dir=out_dir,
                                    **common)
            check_confs.append(np.asarray(c, np.int64))
            served.append(_read_png(os.path.join(out_dir, f"frame_{j}.png")))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    del model
    harness.free_cache(dev)

    precision.exact_f32()
    st = {k: v.to(dev) for k, v in state.items()}
    weigh = lambda confs: sum(int(n) * np.asarray(c, np.int64)  # noqa: E731
                              for n, c in zip(counts_seen, confs))
    ref = reference_sweep(spec, st, frames, labels, classes, precision.Exact(), dev, served)
    numbers = {
        "window_check_diff": float(np.abs(np.asarray(conf, np.int64)
                                          - weigh(check_confs)).sum()),
        "logit_gap": ref["gap"],
    }
    if control:
        numbers["class_mismatch_share"] = mismatch_share(np.asarray(conf),
                                                         weigh(ref["confusions"]))
        low = reference_sweep(spec, st, frames, labels, classes,
                              precision.Rounded(torch.bfloat16), dev)
        numbers["control.logit_gap"] = reference_sweep(spec, st, frames, labels, classes,
                                                       precision.Exact(), dev,
                                                       low["maps"])["gap"]
        numbers["control.class_mismatch_share"] = mismatch_share(
            weigh(low["confusions"]), weigh(ref["confusions"]))
    record = {"frames": frames_scored, "window_s": window_s, "setup_s": setup_s,
              "peak": peak, "numbers": numbers, "finite": True, "spans": span_record}
    if trace:
        record.update(counts.eval_frame_counts(spec, frame))
        record["frame"] = frame
        if "stopped" in box:
            prof, wall, n = box.pop("stopped")
            record["trace"] = harness.Trace.from_profiler(prof, wall, EVAL_STAGES, frames=n)
    return record


def _trace_hook(box: dict, i: int, traffic: dict, dev) -> None:
    first, n = traffic["trace_from"], traffic["trace_frames"]
    if i == first:
        harness.sync(dev)
        box["prof"] = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA])
        box["prof"].start()
        box["t0"] = harness.now()
    elif i == first + n and "prof" in box:
        _stop(box, dev, n)


def _stop(box: dict, dev, frames: int) -> None:
    harness.sync(dev)
    wall = harness.now() - box["t0"]
    prof = box.pop("prof")
    prof.stop()
    # the events are read after the window
    box["stopped"] = (prof, wall, frames)
