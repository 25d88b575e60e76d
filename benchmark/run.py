"""Run one cell of the benchmark and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. `--trace 0` prints the cell's end-to-end
metrics, `--trace 1` its per-layer metrics read from a profiled stretch of
the window. The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` `breakdown`,
and last `checks`, each number compared with its limit (also the last lines
of standard error). Exit codes: 0 a result was printed; 2 the host has fewer
CUDA devices than the cell asks for; 3 a module of JAX or of the JAX package
was loaded; 1 anything else.
"""

from __future__ import annotations

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)
# every build and kernel cache of the run at a fixed place in the checkout
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build", "torch_extensions")
os.environ["USE_FLAX"] = "0"

import argparse  # noqa: E402
import json  # noqa: E402

from benchmark import harness  # noqa: E402

EXIT_NO_CARD, EXIT_FORBIDDEN = 2, 3
# the work counts of a traced run (`reference/counts.py`), printed beside the readings
COUNTS = ("flops_per_step", "heads", "flops_per_frame", "logits")


def _driver(cell: harness.Cell):
    kind = cell.traffic["kind"]
    if kind == "train":
        from benchmark.drivers import train
        return train.run
    if kind == "eval":
        from benchmark.drivers import eval as eval_driver
        return eval_driver.run
    raise ValueError(f"no driver for traffic kind {kind!r}")


def end_to_end(cell: harness.Cell, rec: dict) -> dict:
    units = {m["name"]: m["unit"] for m in cell.end_to_end}
    values = {"setup_s": rec["setup_s"], "peak_mem_gib": rec["peak"] / 2 ** 30}
    if "steps" in rec:
        values["train_images_per_s"] = rec["images"] / rec["window_s"]
    if "frames" in rec:
        values["eval_frames_per_s"] = rec["frames"] / rec["window_s"]
    return {k: {"value": values[k], "unit": units[k]} for k in units}


def result(cell: harness.Cell, rec: dict, trace: bool) -> tuple:
    correct, checks = harness.verdict(rec["numbers"], cell.limits)
    correct = correct and rec["finite"]
    attempted = rec.get("steps", rec.get("frames", 0))
    out = {"correct": bool(correct), "attempted": int(attempted),
           "failed": 0 if correct else int(attempted)}
    t = rec.get("trace")
    if trace:
        out["metrics"] = harness.read_per_layer(cell, rec) if t is not None else {}
        out["device"] = harness.device_record(cell.chips, rec["peak"], t)
        if t is not None:
            out["breakdown"] = harness.breakdown(t)
    else:
        out["metrics"] = end_to_end(cell, rec)
        out["device"] = harness.device_record(cell.chips, rec["peak"])
    return out, checks


def main(argv=None) -> int:
    t_origin = harness.now() - harness.process_age_s()
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true",
                    help="also compute the control's and the faults' numbers "
                         "(printed on standard error; not part of a benchmark run)")
    args = ap.parse_args(argv)
    cell = harness.Cell(args.workload)
    if "host_cpus" in cell.traffic:
        harness.pin_host(int(cell.traffic["host_cpus"]))
    try:
        harness.require_cuda(cell.chips)
    except harness.NoCard as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return EXIT_NO_CARD
    print(f"card: {harness.power_limit()}", file=sys.stderr)
    rec = _driver(cell)(cell, args.seed, args.seconds, bool(args.trace), "cuda", t_origin,
                        args.control)
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return EXIT_FORBIDDEN
    print("readings " + json.dumps(rec["numbers"], default=str), file=sys.stderr)
    counted = {k: rec[k] for k in COUNTS if k in rec}
    if counted:
        print("counts " + json.dumps(counted), file=sys.stderr)
    out, checks = result(cell, rec, bool(args.trace))
    harness.emit(out, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
