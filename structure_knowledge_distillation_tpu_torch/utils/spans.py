"""Spans, counters and device phase marks: the port's one tracing module.

Recording is off until `start()`, which clears what was recorded; `stop()`
ends it and returns a `Record`. Off, each instrumentation point costs one
check of a global flag: `span` hands back a shared no-op context, `count`
returns, and nothing is kept on the host or the device.

  * `with span(name):` a host span: `time.time_ns()` (the host's
    `CLOCK_REALTIME`) at entry and exit, its parent the innermost span open
    on the same thread. It emits no `record_function`, so it adds nothing to
    a profiler's device timeline. On the profiler's timeline a span sits at
    `(t_ns - trace_start_ns) / 1000` µs, `trace_start_ns` being
    `prof.profiler.kineto_results.trace_start_ns()` (`Record.on_trace`).
    `spanned(name)` is the same span around every call of a function, and
    `iterate(iterable, name, next_name)` opens a root span `name` for each
    item, with the wait for the item as its child `next_name`, and keeps it
    open while the loop's body runs.
  * `count(name, n=1)`: a counter.
  * `with phase(name, like):` a phase of the train step. It always opens
    `torch.profiler.record_function(name)`. While recording it is also a
    host span of that name and, when `like` is a CUDA tensor, brackets the
    phase with two launches of the one-thread mark kernel
    (`csrc/mark.cu`, `skd_mark_kernel`) on the current stream of `like`'s
    device: each writes (phase, begin or end, the device's nanosecond timer)
    into a ring in device memory. Inside a CUDA-graph capture the marks
    become nodes of the graph, so every replay writes fresh stamps; a graph
    captured while recording was off holds no marks, and one captured while
    recording keeps writing them into the ring after `stop()` (the next
    `start()` zeroes its cursor). So phases exist only in graphs captured
    while recording. Under `torch.export`, `torch.compile` or a fake-tensor
    mode (`ops/_build.py::tracing`) and on CPU tensors nothing is launched.
    The ring (1 MiB a device, the newest `RING_CAPACITY` marks) is
    allocated at the device's first mark, or by `reserve` before a capture,
    and lives as long as the process, since a captured graph writes into it
    by address.

`stop()` synchronizes each device with a ring once, copies the ring back
and pairs each phase's begin and end stamps into device durations, in
order (`Record.phases`, ms; `Record.stamps`, the raw marks).

Where the port records (names as `PERF.md` §3 lists them):
  * trainer (`training/trainer.py`): `trainer.init` (`KDTrainer.__init__`)
    and the counter `teacher.fused_abn` (the frozen teacher's ABNs that take
    the fused eval kernel K6); per chunk of `fit` the root `fit.chunk` with
    the children `fit.next` (the wait for the next chunk from the iterator),
    `fit.log` (the read of a logged chunk's metrics, the host waiting for
    the device), `fit.eval`, `fit.save`, `fit.profile` (`profile_dir`'s
    profiler started or stopped);
  * multi-step loop (`training/train_step.py`): `loop.eager` (a chunk run
    eagerly), `loop.capture` (the capture `TrainLoop.capture_ms` times),
    `loop.stage` (a replay's static-input copies and host draws, with the
    wait for the pinned staging buffer as the child `loop.stage.wait`),
    `loop.launch` (`graph.replay()` and the outputs' clones); the phases
    `teacher_forward`, `student_loss_and_grad`, `d_loss_and_grad`;
  * kernels (`ops/_build.py`): `kernels.load` (nvcc when the build
    directory is cold) and the counter `kernels.built`;
  * eval sweep (`training/evaluate.py::evaluate_main`): per frame the root
    `eval.frame` with `eval.next` (the loader's yield), `eval.wire` (host
    quantization and narrowing), `eval.to_device` (pinning and the copies'
    enqueue) and `eval.launch` (forward, K1 and the confusion enqueued).

`Record`'s readings (`device_ms_a_step`, `host_ms_a_chunk`, `setup_s`,
`host_ms_a_frame`, `idle_share`, `outside_ms`) are what `fit` logs with
`profile_dir` and what `scripts/trace_cells.py` prints for a benchmark
cell. Each process records its own spans (a data-parallel rank included).
"""

from __future__ import annotations

import contextlib
import functools
import logging
import statistics
import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import torch
from torch.profiler import record_function

__all__ = ["start", "stop", "recording", "span", "spanned", "iterate", "count", "phase",
           "reserve", "Record", "RING_CAPACITY"]

log = logging.getLogger(__name__)

RING_CAPACITY = 1 << 16  # marks a device's ring keeps (16 bytes each)

_on = False
_state: Optional["_Recorder"] = None
_lock = threading.Lock()
_local = threading.local()
_phase_ids: Dict[str, int] = {}
_phase_names: List[str] = []
_rings: Dict[torch.device, torch.Tensor] = {}
_unmarked: set = set()  # devices whose missing ring was reported


_NULL = contextlib.nullcontext()  # what `span` hands back while recording is off

# a replayed chunk's host parts (`Record.host_ms_a_chunk`)
CHUNK_PARTS = ("loop.stage", "loop.stage.wait", "loop.launch", "fit.next", "fit.log",
               "fit.eval", "fit.save", "fit.profile")
# set-up (`Record.setup_s`)
SETUP = ("trainer.init", "loop.eager", "loop.capture", "kernels.load")
# a frame's host parts (`Record.host_ms_a_frame`)
FRAME_PARTS = ("eval.next", "eval.wire", "eval.to_device", "eval.launch")


class _Recorder:
    def __init__(self):
        self.spans: List[list] = []
        self.counters: Dict[str, int] = {}


def _union(intervals) -> float:
    """The length of the union of (start, end) intervals."""
    total, cur_a, cur_b = 0.0, None, None
    for a, b in sorted(intervals):
        if b <= a:
            continue
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _mean(values: Sequence[float]) -> float:
    return sum(values) / len(values)


@dataclass
class Record:
    """What one recording held.

    `spans`: (name, start_ns, end_ns, parent) in the order they opened, the
    times on the host's `CLOCK_REALTIME`, `parent` the enclosing span's
    index or -1 (a span still open at `stop` ends there); `counters`;
    `phases`: device ms of each bracketed phase, in order; `stamps`: the
    marks as read back, (phase, is_end, device ns), in the order written."""

    spans: List[Tuple[str, int, int, int]] = field(default_factory=list)
    counters: Dict[str, int] = field(default_factory=dict)
    phases: Dict[str, List[float]] = field(default_factory=dict)
    stamps: List[Tuple[str, bool, int]] = field(default_factory=list)

    def named(self, name: str) -> List[int]:
        return [i for i, s in enumerate(self.spans) if s[0] == name]

    def ms(self, name: str) -> List[float]:
        """Host ms of every span called `name`, in order."""
        return [(self.spans[i][2] - self.spans[i][1]) / 1e6 for i in self.named(name)]

    def children(self, i: int) -> List[int]:
        return [j for j, s in enumerate(self.spans) if s[3] == i]

    def root(self, i: int) -> int:
        while self.spans[i][3] >= 0:
            i = self.spans[i][3]
        return i

    def within(self, i: int, name: str) -> bool:
        """Whether span i lies beneath a span called `name`."""
        while self.spans[i][3] >= 0:
            i = self.spans[i][3]
            if self.spans[i][0] == name:
                return True
        return False

    def self_ns(self, i: int) -> int:
        """Span i's duration less the part of it that its children cover."""
        _, a, b, _ = self.spans[i]
        return (b - a) - int(_union((max(self.spans[j][1], a), min(self.spans[j][2], b))
                                    for j in self.children(i)))

    def per_root_ms(self, root: str, name: str) -> List[float]:
        """For each span called `root` with no parent, the host ms of the
        spans called `name` beneath it (itself when `name` is `root`: its
        self time)."""
        roots = [i for i in self.named(root) if self.spans[i][3] < 0]
        if name == root:
            return [self.self_ns(i) / 1e6 for i in roots]
        out = dict.fromkeys(roots, 0.0)
        for j in self.named(name):
            r = self.root(j)
            if r in out:
                out[r] += (self.spans[j][2] - self.spans[j][1]) / 1e6
        return [out[i] for i in roots]

    # -- the train loop
    def replayed_phases(self) -> Dict[str, List[float]]:
        """Each phase's device ms at the steps a captured graph replayed.
        An eager step's phase is a host span outside `loop.capture` and one
        pair of stamps; those before the first `loop.launch` lead the
        stamps and the others follow the replays', so both are dropped.
        Empty when nothing was replayed or the ring overflowed."""
        launches = [self.spans[i][1] for i in self.named("loop.launch")]
        if not launches:
            return {}
        first = min(launches)
        out = {}
        for name, ms in self.phases.items():
            eager = [i for i in self.named(name) if not self.within(i, "loop.capture")]
            lead = sum(self.spans[i][1] < first for i in eager)
            replayed = ms[lead:len(ms) - (len(eager) - lead)]
            if replayed and len(self.stamps) < RING_CAPACITY:
                out[name] = replayed
        return out

    def device_ms_a_step(self) -> Dict[str, float]:
        """The median device ms of each phase over the replayed steps, or
        over every marked step where none was replayed (or the ring
        overflowed)."""
        phases = self.replayed_phases() or self.phases
        return {k: statistics.median(v) for k, v in phases.items() if v}

    def replayed_chunks(self) -> List[int]:
        """The `fit.chunk` roots that replayed a captured graph (a
        `loop.launch` beneath them, no `loop.capture`)."""
        launched = {self.root(j) for j in self.named("loop.launch")}
        captured = {self.root(j) for j in self.named("loop.capture")}
        return [i for i in self.named("fit.chunk")
                if self.spans[i][3] < 0 and i in launched and i not in captured]

    def host_ms_a_chunk(self) -> Dict[str, float]:
        """The mean host ms a replayed chunk in each of `CHUNK_PARTS`, in
        `fit.chunk` (its self time), and `enqueue`: `loop.stage` less
        `loop.stage.wait`, `loop.launch` and the chunk's self time (the
        host's work, not its waits). Empty without a replayed chunk."""
        chunks = self.replayed_chunks()
        if not chunks:
            return {}
        roots = [i for i in self.named("fit.chunk") if self.spans[i][3] < 0]
        keep = [roots.index(i) for i in chunks]
        out = {}
        for name in CHUNK_PARTS + ("fit.chunk",):
            per = self.per_root_ms("fit.chunk", name)
            out[name] = _mean([per[k] for k in keep])
        out["enqueue"] = (out["loop.stage"] - out["loop.stage.wait"] + out["loop.launch"]
                          + out["fit.chunk"])
        return out

    def setup_s(self) -> Dict[str, float]:
        """Seconds in each of `SETUP` that the record holds."""
        return {name: sum(self.ms(name)) / 1e3 for name in SETUP if self.named(name)}

    # -- the eval sweep
    def host_ms_a_frame(self) -> Dict[str, float]:
        """The mean host ms a scored frame (an `eval.frame` root with an
        `eval.launch`) in each of `FRAME_PARTS` and in the whole frame
        (`eval.frame`). Empty without a scored frame."""
        roots = [i for i in self.named("eval.frame") if self.spans[i][3] < 0]
        scored = {self.root(j) for j in self.named("eval.launch")}
        keep = [k for k, i in enumerate(roots) if i in scored]
        if not keep:
            return {}
        out = {}
        for name in FRAME_PARTS:
            per = self.per_root_ms("eval.frame", name)
            out[name] = _mean([per[k] for k in keep])
        out["eval.frame"] = _mean([(self.spans[roots[k]][2] - self.spans[roots[k]][1]) / 1e6
                                   for k in keep])
        return out

    # -- on the profiler's timeline
    def on_trace(self, name: str, trace_start_ns: int) -> List[Tuple[float, float]]:
        """The spans called `name` on the profiler's timeline: (start, end)
        in µs from `trace_start_ns`, the profiler's
        `prof.profiler.kineto_results.trace_start_ns()`."""
        return [((self.spans[i][1] - trace_start_ns) / 1e3,
                 (self.spans[i][2] - trace_start_ns) / 1e3) for i in self.named(name)]

    def idle_share(self, gaps_us, name: str, trace_start_ns: int) -> float:
        """The share (0–1) of the gaps' length, (start, end) µs on the
        profiler's timeline, during which the host was inside a span called
        `name`; NaN without gaps."""
        total = sum(b - a for a, b in gaps_us)
        if total <= 0:
            return float("nan")
        spans_us = self.on_trace(name, trace_start_ns)
        return sum(_union((max(sa, a), min(sb, b)) for sa, sb in spans_us)
                   for a, b in gaps_us) / total

    def outside_ms(self, events_us, name: str, trace_start_ns: int) -> float:
        """The most by which an event, (start, end) µs on the profiler's
        timeline, lies outside every span called `name`, in ms (0 when each
        lies inside one; inf when there is no such span)."""
        spans_us = self.on_trace(name, trace_start_ns)
        worst = 0.0
        for a, b in events_us:
            worst = max(worst, min((max(sa - a, 0.0) + max(b - sb, 0.0) for sa, sb in spans_us),
                                   default=float("inf")))
        return worst / 1e3


def recording() -> bool:
    return _on


def start() -> None:
    """Begin recording; what an earlier recording held is dropped, and the
    device rings' cursors are zeroed."""
    global _on, _state
    for dev, ring in _rings.items():
        torch.cuda.synchronize(dev)
        ring[0].zero_()
        torch.cuda.synchronize(dev)
    _local.stack = []
    _state = _Recorder()
    _on = True


def stop(read_marks: bool = True) -> Record:
    """End recording and return what it held. With `read_marks` false the
    devices are not touched and the record has no phases (for a caller
    unwinding from an error, which a synchronize could hide)."""
    global _on, _state
    _on = False
    rec, _state = _state, None
    if rec is None:
        return Record()
    now = time.time_ns()
    spans = [(n, a, b if b >= 0 else now, p) for n, a, b, p in rec.spans]
    stamps: List[Tuple[str, bool, int]] = []
    phases: Dict[str, List[float]] = {}
    for dev, ring in (_rings.items() if read_marks else ()):
        torch.cuda.synchronize(dev)
        stamps += _read_ring(ring.cpu())
    opened: Dict[str, int] = {}
    for name, is_end, t in stamps:
        if not is_end:
            opened[name] = t
        elif name in opened:
            phases.setdefault(name, []).append((t - opened.pop(name)) / 1e6)
    return Record(spans, dict(rec.counters), phases, stamps)


def _read_ring(host: torch.Tensor) -> List[Tuple[str, bool, int]]:
    n = int(host[0])
    cap = (host.numel() - 2) // 2
    entries = host[2:].view(cap, 2).tolist()
    out = []
    for i in range(max(0, n - cap), n):
        code, t = entries[i % cap]
        out.append((_phase_names[code >> 1], bool(code & 1), t))
    return out


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Span:
    __slots__ = ("_name", "_rec", "_index")

    def __init__(self, name: str):
        self._name = name
        self._rec = None

    def __enter__(self):
        rec = self._rec = _state
        if rec is None:
            return self
        stack = _stack()
        parent = stack[-1][1] if stack and stack[-1][0] is rec else -1
        t = time.time_ns()
        with _lock:
            self._index = len(rec.spans)
            rec.spans.append([self._name, t, -1, parent])
        stack.append((rec, self._index))
        return self

    def __exit__(self, *exc):
        if self._rec is not None:
            self._rec.spans[self._index][2] = time.time_ns()
            stack = _stack()
            if stack and stack[-1] == (self._rec, self._index):
                stack.pop()
        return False


def span(name: str):
    """A host span while recording; a shared no-op context otherwise."""
    return _Span(name) if _on else _NULL


def spanned(name: str):
    """A decorator: every call of the function is a host span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _on:
                return fn(*args, **kwargs)
            with _Span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


_END = object()


def iterate(iterable: Iterable, name: str, next_name: str):
    """The items of `iterable`, each under a root span `name` that holds
    the wait for the item (`next_name`) and stays open until the next item
    is asked for, so it covers the loop's body as well."""
    it = iter(iterable)
    while True:
        with span(name):
            with span(next_name):
                item = next(it, _END)
            if item is _END:
                return
            yield item


def count(name: str, n: int = 1) -> None:
    if _on:
        with _lock:
            _state.counters[name] = _state.counters.get(name, 0) + n


def _ring(device: torch.device, allocate: bool) -> Optional[torch.Tensor]:
    ring = _rings.get(device)
    if ring is None and allocate:
        ring = torch.zeros(2 + 2 * RING_CAPACITY, dtype=torch.int64, device=device)
        torch.cuda.synchronize(device)
        _rings[device] = ring
    return ring


def reserve(device: torch.device) -> None:
    """While recording, make `device`'s ring before a CUDA-graph capture on
    it: a capture cannot allocate and zero it, and its marks would be
    left out."""
    if _on and device.type == "cuda":
        _ring(device, True)


def _mark(name: str, is_end: bool, like: torch.Tensor) -> None:
    from structure_knowledge_distillation_tpu_torch.ops import _build

    if _build.tracing():
        return
    device = like.device
    ring = _ring(device, not torch.cuda.is_current_stream_capturing())
    if ring is None:
        if device in _unmarked:
            return
        _unmarked.add(device)
        log.warning("phase %s: no mark ring on %s before the capture; the graph is not "
                    "marked (spans.reserve before capturing)", name, device)
        return
    with _lock:
        if name not in _phase_ids:
            _phase_ids[name] = len(_phase_names)
            _phase_names.append(name)
        code = 2 * _phase_ids[name] + int(is_end)
    lib = _build.load_kernels()
    stream = torch.cuda.current_stream(device).cuda_stream
    err = lib.skd_mark(ring.data_ptr(), RING_CAPACITY, code, stream)
    if err != 0:
        raise RuntimeError(f"mark kernel launch failed: cudaError {err}")


class phase:
    """`with phase(name, like):` see the module's docstring."""

    __slots__ = ("_name", "_like", "_rf", "_span", "_marked")

    def __init__(self, name: str, like: torch.Tensor):
        self._name, self._like = name, like

    def __enter__(self):
        self._rf = record_function(self._name)
        self._rf.__enter__()
        self._span = self._marked = None
        if _on:
            self._span = _Span(self._name).__enter__()
            if self._like.is_cuda:
                self._marked = True
                _mark(self._name, False, self._like)
        return self

    def __exit__(self, *exc):
        try:
            if self._marked and exc[0] is None:
                _mark(self._name, True, self._like)
            if self._span is not None:
                self._span.__exit__(*exc)
        finally:
            self._rf.__exit__(*exc)
        return False
