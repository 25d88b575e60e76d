"""What every cell of the benchmark shares: the manifest, the cell's files,
the device check, the profiler's reading, the comparison's verdict and the
result line.

A cell is an entry of `BENCHMARK.json`'s `workloads`. Its files are found by
name: `configs/<config>.json` (the models and the recipe), `traffic/
<traffic>.json` (the inputs and the loop; its `kind` picks the driver in
`drivers/`), `limits/<cell>.json` (the limit of each number compared), for
each network the configuration names, `networks/<arch>.py`
(`reference/archs.py`) and, for every per-layer metric the cell reports,
`metrics/<metric>.py`. A reader that sets `SPANS = True` has the port's
span record in a traced run, put in the run as `spans` (None where no reader
asks, or the program records none). The train driver records from before
the trainer is built, so that the captured graph holds the phase marks; the
eval driver records the window alone, from after the warm-up sweep (its
frames include those before the profiled stretch, which `Record.on_trace`
with the trace's `start_ns` tells apart). The opt-in is the cell's, not the
reader's: once one reader of a cell asks, every traced run of the cell
records, and on train the marks replay with each graph and lie inside the
profiled stretch. So the PR that adds the first such reader to a cell
measures that cell's other traced readings and its breakdown again.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent
REPO = BENCH_DIR.parent
METRICS_DIR = BENCH_DIR / "metrics"
FORBIDDEN = ("jax", "jaxlib", "flax", "structure_knowledge_distillation_tpu")


class NoCard(RuntimeError):
    """The run asked for more CUDA devices than this host has."""


def process_age_s() -> float:
    """Seconds since this process started (from /proc; 0 where unreadable)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


class Cell:
    """A workload of the manifest with its files and the metrics it reports."""

    def __init__(self, name: str, manifest: Optional[dict] = None):
        self.manifest = manifest if manifest is not None else load_json(REPO / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.manifest["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        self.entry = cells[name]
        self.name = name
        self.chips = int(self.entry["chips"])
        configs = {c["name"]: c for c in self.manifest["configs"]}
        self.config = load_json(REPO / configs[self.entry["config"]]["file"])
        self.traffic = load_json(BENCH_DIR / "traffic" / f"{self.entry['traffic']}.json")
        limits = BENCH_DIR / "limits" / f"{name}.json"
        self.limits = load_json(limits) if limits.exists() else {}
        self.end_to_end = [m for m in self.manifest["end_to_end"] if self._reports(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in self.manifest["per_layer"]
                          if (name in m["workloads"] if "workloads" in m
                              else m["moves"] in reported)]

    def _reports(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]


def require_cuda(chips: int):
    """The number of cards, or NoCard: a measuring path never falls back to
    the CPU."""
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise NoCard(f"this cell needs {chips} CUDA device(s); the host has {have}")
    return chips


def pin_host(cpus: int) -> List[int]:
    """Hold this process, and every thread it starts from here on, to `cpus`
    fixed CPUs (the last of those it may use), with one torch thread: where
    the host sets a cell's pace, its share of the host is then the same from
    run to run, and its large host copies (pinning a frame) run on the main
    thread at one pace, where split over several threads each copy waits for
    its slowest part. Call it before torch starts its threads."""
    import torch

    keep = sorted(os.sched_getaffinity(0))[-cpus:]
    os.sched_setaffinity(0, keep)
    torch.set_num_threads(1)
    return keep


def forbidden_modules() -> List[str]:
    """Top-level names of loaded modules that the benchmark must not load,
    compared whole (the port's name begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def power_limit() -> str:
    """The card's name and power limit as `nvidia-smi` reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=False)
        return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"


# ------------------------------------------------------------ the profiler
class Trace:
    """The device intervals and host events of one profiled stretch.

    `device`: (name, start_us, end_us) of every kernel, copy and set on a
    CUDA device (the `record_function` ranges, which the trace repeats on
    the device, left out); `host`: the same of the host's events; `wall_s`:
    the stretch's length on the host clock; `steps` and `frames`: the work
    the stretch held; `start_ns`: the profiler's `trace_start_ns`, from
    which the port's span record maps its spans onto these µs
    (`Record.on_trace`)."""

    def __init__(self, device, host, wall_s: float, steps: int = 0, frames: int = 0,
                 start_ns: int = 0):
        self.device, self.host, self.wall_s = device, host, wall_s
        self.steps, self.frames, self.start_ns = steps, frames, start_ns

    @classmethod
    def from_profiler(cls, prof, wall_s: float, ranges=(), **work) -> "Trace":
        import torch

        dev, host = [], []
        for e in prof.events():
            row = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if e.name not in ranges:
                    dev.append(row)
            else:
                host.append(row)
        return cls(dev, host, wall_s, start_ns=prof.profiler.kineto_results.trace_start_ns(),
                   **work)

    def busy_us(self) -> float:
        return union_us([(a, b) for _, a, b in self.device])

    def time_us(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return sum(b - a for n, a, b in self.device if rx.search(n))


def union_us(spans) -> float:
    """Length of the union of (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(spans):
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def idle_gaps(trace: Trace) -> List[tuple]:
    """(start, end) of every gap between the device's busy intervals."""
    spans = sorted((a, b) for _, a, b in trace.device)
    gaps, cur_b = [], None
    for a, b in spans:
        if cur_b is not None and a > cur_b:
            gaps.append((cur_b, a))
        cur_b = b if cur_b is None else max(cur_b, b)
    return gaps


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The device operations that took most time, and the idle gaps summed
    by the innermost host event that covered each gap's middle."""
    ops = defaultdict(float)
    for n, a, b in trace.device:
        ops[n] += (b - a) / 1e6
    host = sorted(trace.host, key=lambda r: r[1])
    gaps = defaultdict(float)
    for a, b in idle_gaps(trace):
        mid, best = 0.5 * (a + b), None
        for n, ha, hb in host:
            if ha > mid:
                break
            if hb >= mid and (best is None or hb - ha < best[1]):
                best = (n, hb - ha)
        gaps["host: " + (best[0] if best else "python")] += (b - a) / 1e6
    def top_of(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": top_of(ops), "idle_gaps": top_of(gaps)}


def load_metric(metric: str) -> ModuleType:
    """The per-layer metric's own file, `METRICS_DIR/<metric>.py`."""
    path = METRICS_DIR / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark_metric_{metric}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_reader(metric: str) -> Callable:
    """`read(run)` of the per-layer metric's own file."""
    return load_metric(metric).read


def wants_spans(cell: Cell) -> bool:
    """Whether a per-layer reader of the cell sets `SPANS = True`: it reads
    the port's span record, `run["spans"]`."""
    return any(getattr(load_metric(m["name"]), "SPANS", False) for m in cell.per_layer)


def start_spans() -> Optional[ModuleType]:
    """Start the port's span recording (`utils.spans`); the module, whose
    `stop()` returns the `Record`, or None where the program has none."""
    try:
        from structure_knowledge_distillation_tpu_torch.utils import spans
    except ModuleNotFoundError:
        return None
    spans.start()
    return spans


def read_per_layer(cell: Cell, run) -> Dict[str, dict]:
    out = {}
    for m in cell.per_layer:
        value = load_reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


# ------------------------------------------------------------- the verdict
def leaf_gap(program: Dict[str, float], reference: Dict[str, float], keep,
             over: Callable = max) -> float:
    """The worst leaf's gap of norms (`over=max`; `statistics.median` for the
    median leaf's): |‖program‖ − ‖reference‖| over the larger of the
    reference's norm of that leaf and the median leaf's, over the leaves in
    `keep`."""
    names = [k for k in reference if k in keep]
    if not names:
        return math.nan
    gaps = [abs(program.get(k, math.nan) - reference[k]) for k in names]
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    med = statistics.median(reference[k] for k in names)
    return over([g / max(reference[k], med, 1e-30) for g, k in zip(gaps, names)])


def worst_leaf(program: Dict[str, float], reference: Dict[str, float], keep) -> str:
    """The leaf that sets `leaf_gap`'s worst gap."""
    names = [k for k in reference if k in keep]
    med = statistics.median(reference[k] for k in names)
    return max(names, key=lambda k: abs(program.get(k, math.inf) - reference[k])
               / max(reference[k], med, 1e-30))


def sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reset_peak(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)


def peak_bytes(dev) -> int:
    import torch

    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def free_cache(dev) -> None:
    import gc

    import torch

    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()


def warm_profiler(dev) -> None:
    """Start the profiler's tracing once outside the window: its first start
    on the card takes seconds."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts):
        (torch.ones(8, device=dev) * 2).sum().item()


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> tuple:
    """(correct, checks) over the numbers the cell's limits name: each
    finite and at or under its limit. A limit without its number, or no
    limit at all, is not correct."""
    checks, ok = {}, bool(limits)
    for name in sorted(limits):
        value, limit = numbers.get(name, math.nan), limits.get(name, math.nan)
        checks[name] = {"value": value, "limit": limit}
        ok = ok and math.isfinite(value) and math.isfinite(limit) and value <= limit
    return ok, checks


def emit(result: dict, checks: Dict[str, dict]) -> None:
    """The numbers compared on standard error's last lines, then the result
    as standard output's last line, its `checks` key last."""
    for name, c in checks.items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    result = dict(result)
    result["checks"] = checks
    print(json.dumps(result, allow_nan=True), flush=True)


def device_record(chips: int, peak_bytes: int, trace: Optional[Trace] = None) -> dict:
    import torch

    rec = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
           "memory_peak_bytes": int(peak_bytes)}
    if trace is not None:
        rec["busy_s"] = trace.busy_us() / 1e6
        rec["window_s"] = trace.wall_s
    return rec


def now() -> float:
    return time.perf_counter()
