"""Run one cell of the benchmark with the port's spans recorded, and print
what the spans say.

    python3 scripts/trace_cells.py --workload <cell> --seed <n> --seconds 20 \
        --trace <0|1> --record <0|1> [--out outputs/trace_cells.jsonl]

From the root of a checkout, on a host with a CUDA device. The run is the
benchmark's own (`benchmark/run.py`'s set-up, window and check); with
`--record 1` the spans of `structure_knowledge_distillation_tpu_torch.utils
.spans` are recorded from before the program is built to the end of the
check, so the train cell's CUDA graph is captured with its phase marks.
`--record 0 --trace 0` is a plain benchmark run: the pair measures what
recording costs. One JSON line goes to standard output (and to `--out`):
the end-to-end numbers and `correct`, and with `--record 1` the readings
of `spans.Record`, which computes them (the script only picks the events):

  * train (`spans`): the median device ms a step of each phase over the
    replayed steps (`teacher_ms`, `student_ms`, `disc_ms`, `steps`) and
    their sum; `host_ms_per_chunk`, a replayed chunk's `enqueue`
    (`loop.stage` less `loop.stage.wait`, `loop.launch` and the self time
    of `fit.chunk`), with every part in `chunk_parts_ms`; `setup_s` (s in
    `trainer.init`, `loop.eager`, `loop.capture`, `kernels.load`);
  * eval (`spans`): `frame_ms`, the mean host ms a scored frame in
    `eval.next`, `eval.wire`, `eval.to_device`, `eval.launch` and the
    whole `eval.frame`;
  * with `--trace 1` as well, from the profiled stretch: `busy_ms_per_step`
    (train) and, the spans mapped onto the profiler's clock
    (`trace_start_ns`), `idle_in_eval.to_device` (eval: the share, in %, of
    the device's idle time during which the host was inside
    `eval.to_device`; likewise `eval.launch`, `eval.next`), and the clock
    checks: the most by which a `cudaGraphLaunch` lies outside every
    `loop.launch` span (train), or a pinning `aten::copy_` outside every
    `eval.to_device` span (eval), in ms, with the events checked (each
    `aten::pin_memory` and each `aten::copy_` beneath one).

The benchmark's run record keeps the profiler's events, not the profiler,
so for the clock the script holds on to the profiler that
`harness.Trace.from_profiler` is handed, for the run's length.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmark import harness  # noqa: E402

PHASES = {"teacher_ms": "teacher_forward", "student_ms": "student_loss_and_grad",
          "disc_ms": "d_loss_and_grad"}


def _has_ancestor(e, names) -> bool:
    p = e.cpu_parent
    while p is not None:
        if p.name in names:
            return True
        p = p.cpu_parent
    return False


def train_readings(rec, trace, prof) -> dict:
    steps = rec.device_ms_a_step()
    out = {key: steps.get(name) for key, name in PHASES.items()}
    out["steps"] = {name: len(v) for name, v in rec.replayed_phases().items()}
    if all(out[k] is not None for k in PHASES):
        out["phases_ms"] = sum(out[k] for k in PHASES)
    chunk = rec.host_ms_a_chunk()
    if chunk:
        out["host_ms_per_chunk"] = chunk["enqueue"]
        out["chunk_parts_ms"] = chunk
        out["replayed_chunks"] = len(rec.replayed_chunks())
    out["setup_s"] = rec.setup_s()
    out["counters"] = rec.counters
    if trace is not None and prof is not None:
        t0 = prof.profiler.kineto_results.trace_start_ns()
        out["busy_ms_per_step"] = trace.busy_us() / 1e3 / trace.steps
        launches = [(a, b) for n, a, b in trace.host if n == "cudaGraphLaunch"]
        out["graph_launches_checked"] = len(launches)
        out["graph_launch_outside_ms"] = rec.outside_ms(launches, "loop.launch", t0)
    return out


def eval_readings(rec, trace, prof) -> dict:
    out = {"frame_ms": rec.host_ms_a_frame()}
    if trace is not None and prof is not None:
        t0 = prof.profiler.kineto_results.trace_start_ns()
        gaps = harness.idle_gaps(trace)
        out["idle_ms"] = sum(b - a for a, b in gaps) / 1e3
        for name in ("eval.to_device", "eval.launch", "eval.next"):
            out["idle_in_" + name] = 100.0 * rec.idle_share(gaps, name, t0)
        pins = ("aten::pin_memory", "aten::_pin_memory")
        copies = [(e.time_range.start, e.time_range.end) for e in prof.events()
                  if e.name == "aten::pin_memory"
                  or e.name == "aten::copy_" and _has_ancestor(e, pins)]
        out["pinned_copies_checked"] = len(copies)
        out["pinned_copy_outside_ms"] = rec.outside_ms(copies, "eval.to_device", t0)
    return out


def measure(cell, seed: int, seconds: float, trace: bool, record: bool, device: str = "cuda",
            t_origin: float = 0.0) -> dict:
    """One run of `cell` as the benchmark runs it; the result line."""
    from benchmark import run as bench_run  # sets the run's cache directories
    from structure_knowledge_distillation_tpu_torch.utils import spans

    # the run keeps only the profiler's events; the clock checks need the
    # profiler itself (its `trace_start_ns`, the host events' parents)
    held = {}
    from_profiler = harness.Trace.from_profiler.__func__

    def keep_prof(cls, prof, *a, **kw):
        held["prof"] = prof
        return from_profiler(cls, prof, *a, **kw)

    harness.Trace.from_profiler = classmethod(keep_prof)
    try:
        if record:
            spans.start()
        rec = bench_run._driver(cell)(cell, seed, seconds, trace, device, t_origin)
        record_ = spans.stop() if record else None
    finally:
        harness.Trace.from_profiler = classmethod(from_profiler)
    correct, _ = harness.verdict(rec["numbers"], cell.limits)
    line = {"workload": cell.name, "seed": seed, "trace": int(trace), "record": int(record),
            "card": harness.power_limit(), "correct": bool(correct and rec["finite"]),
            "metrics": {k: v["value"] for k, v in bench_run.end_to_end(cell, rec).items()}}
    t = rec.get("trace")
    if t is not None:
        line["busy_s"], line["window_s"] = t.busy_us() / 1e6, t.wall_s
        line["per_layer"] = {k: v["value"] for k, v in harness.read_per_layer(cell, rec).items()}
    if record_ is not None:
        if cell.traffic["kind"] == "train":
            line["spans"] = train_readings(record_, t, held.get("prof"))
        else:
            line["spans"] = eval_readings(record_, t, held.get("prof"))
    return line


def main(argv=None) -> int:
    t_origin = harness.now() - harness.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=20.0)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", type=int, choices=(0, 1), default=1)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    if "host_cpus" in cell.traffic:
        harness.pin_host(int(cell.traffic["host_cpus"]))
    harness.require_cuda(cell.chips)
    line = measure(cell, args.seed, args.seconds, bool(args.trace), bool(args.record),
                   t_origin=t_origin)
    text = json.dumps(line, default=str)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
