"""The port's tracing module (`utils/spans.py`): host spans, counters and
the train step's device phase marks.

On the CPU:
  * while recording is off nothing is kept: `span` hands back one shared
    no-op context, `count`, `phase`, `spanned` and `iterate` leave no
    state, and a later recording starts empty;
  * spans nest by thread, with the right parents; a span still open at
    `stop` ends there; `iterate` holds each item's loop body under its
    root span; self time and the per-chunk sums on a synthetic tree;
  * a `record_function` range opened inside a span lies inside it on the
    profiler's timeline (the span mapped by `trace_start_ns`);
  * the eager multi-step loop on CPU tensors gives the same metrics and
    state, bit for bit, with recording on and off, and records each step's
    three phases as host spans, in order, under `loop.eager`;
  * `evaluate_main` records a frame's spans under `eval.frame`; `fit` with
    `profile_dir` records from its start to the end of the profiler's
    window and logs the spans' line then, and a `fit` cut by an error
    stops recording and logs nothing;
  * `Record`'s readings on hand-made records: the phases of the replayed
    steps, host ms a chunk and a frame, the set-up split, the spans mapped
    onto the profiler's clock (an event outside `loop.launch`, the idle
    time inside `eval.to_device`), and nothing where there is nothing to
    read.

On the card (marked `cuda`, skipped without a CUDA device): a chunk
captured while recording writes 2 stamps × 3 phases × `unroll` steps at
every replay; the phases of a step sum to the replay's CUDA-event time per
step within 5 % (the events on a stream kept busy while the host stages
and launches the replay, so they time the device's work alone); the replay's losses and state are bit-equal to those of a
graph captured with recording off, and a recording-off capture allocates
no mark ring. On a GPU host:

    python -m pytest tests/test_torch_port_spans.py -q -m cuda --noconftest
"""

import logging
import math
import threading

import numpy as np
import pytest
import torch
from test_torch_port_cuda import LOOP_K, _loop_cfg, _loop_chunks, _loop_state

from structure_knowledge_distillation_tpu_torch.models import BASIC, ResPSPNet
from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_loop
from structure_knowledge_distillation_tpu_torch.utils import spans

PHASES = ("teacher_forward", "student_loss_and_grad", "d_loss_and_grad")


@pytest.fixture(autouse=True)
def _off():
    """Every test starts and ends with recording off, on two threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    if spans.recording():
        spans.stop()
    yield
    if spans.recording():
        spans.stop()
    torch.set_num_threads(n)


def test_off_records_nothing():
    assert not spans.recording()
    assert spans.span("a") is spans.span("b")  # the shared no-op context
    with spans.span("a"):
        spans.count("c", 3)
        with spans.phase("teacher_forward", torch.zeros(2)):
            pass
    assert spans.spanned("f")(lambda x: x + 1)(1) == 2
    assert list(spans.iterate(range(3), "item", "item.next")) == [0, 1, 2]
    assert spans._state is None
    spans.start()
    rec = spans.stop()
    assert rec.spans == [] and rec.counters == {} and rec.phases == {} and rec.stamps == []
    assert spans.stop() == spans.Record()  # stopping twice is harmless


def test_spans_nest_by_thread_and_count():
    spans.start()
    assert spans.recording()
    with spans.span("root"):
        with spans.span("a"):
            with spans.span("b"):
                spans.count("n")
        done = threading.Event()

        def other():
            with spans.span("thread"):
                with spans.span("thread.child"):
                    spans.count("n", 2)
            done.set()

        t = threading.Thread(target=other)
        t.start()
        t.join(timeout=10)
        assert done.is_set()
        with spans.span("c"):
            open_span = spans.span("open")
            open_span.__enter__()
    rec = spans.stop()
    names = [s[0] for s in rec.spans]
    parent = {s[0]: (names[s[3]] if s[3] >= 0 else None) for s in rec.spans}
    assert parent == {"root": None, "a": "root", "b": "a", "thread": None,
                      "thread.child": "thread", "c": "root", "open": "c"}
    assert rec.counters == {"n": 3}
    for name, a, b, _ in rec.spans:
        assert 0 < a <= b, name
    # a child lies inside its parent; the span left open ends at stop
    for name, a, b, p in rec.spans:
        if p >= 0:
            assert rec.spans[p][1] <= a and b <= rec.spans[p][2] or name == "open"
    assert rec.spans[names.index("open")][2] >= rec.spans[names.index("root")][2]


def test_iterate_and_spanned_put_the_body_under_each_item():
    @spans.spanned("work")
    def work(x):
        with spans.span("inner"):
            return 2 * x

    spans.start()
    got = []
    for x in spans.iterate(iter([1, 2]), "item", "item.next"):
        got.append(work(x))
    for x in spans.iterate([5, 6], "cut", "cut.next"):
        break  # the item's span ends when the loop lets go of the iterator
    rec = spans.stop()
    assert got == [2, 4]
    names = [s[0] for s in rec.spans]
    parent = [names[p] if p >= 0 else None for _, _, _, p in rec.spans]
    assert list(zip(names, parent)) == [
        ("item", None), ("item.next", "item"), ("work", "item"), ("inner", "work"),
        ("item", None), ("item.next", "item"), ("work", "item"), ("inner", "work"),
        ("item", None), ("item.next", "item"),  # the iterator found empty
        ("cut", None), ("cut.next", "cut")]
    for name, a, b, p in rec.spans:
        assert p < 0 or rec.spans[p][1] <= a <= b <= rec.spans[p][2], name
    assert spans._stack() == []


def test_self_time_and_per_chunk_sums_on_a_synthetic_tree():
    ms = 1_000_000
    rec = spans.Record(spans=[
        ("fit.chunk", 0, 100 * ms, -1),          # 0
        ("loop.stage", 10 * ms, 30 * ms, 0),     # 1
        ("loop.stage.wait", 12 * ms, 20 * ms, 1),
        ("loop.launch", 20 * ms, 50 * ms, 0),    # overlaps loop.stage by 10
        ("fit.log", 60 * ms, 70 * ms, 0),
        ("x", 65 * ms, 68 * ms, 4),
        ("fit.chunk", 100 * ms, 140 * ms, -1),   # 6: eager, no launch
        ("loop.eager", 100 * ms, 130 * ms, 6),
        ("fit.chunk", 140 * ms, 150 * ms, -1),   # 8: only the exhausted next
        ("fit.next", 140 * ms, 150 * ms, 8),
    ], phases={"teacher_forward": [3.0, 1.0, 2.0]})
    assert rec.self_ns(0) == (100 - 40 - 10) * ms
    assert rec.self_ns(4) == 7 * ms
    assert rec.self_ns(8) == 0
    assert rec.children(0) == [1, 3, 4]
    assert rec.root(5) == 0
    assert rec.per_root_ms("fit.chunk", "loop.stage.wait") == [8.0, 0.0, 0.0]
    assert rec.per_root_ms("fit.chunk", "fit.chunk") == [50.0, 10.0, 0.0]
    assert rec.ms("loop.launch") == [30.0]
    assert rec.within(5, "fit.log") and rec.within(5, "fit.chunk")
    assert not rec.within(4, "loop.stage")
    assert rec.replayed_chunks() == [0]
    # no host span of the phase outside a capture: every stamp counts
    assert rec.device_ms_a_step() == {"teacher_forward": 2.0}
    parts = rec.host_ms_a_chunk()
    assert parts == {"loop.stage": 20.0, "loop.stage.wait": 8.0, "loop.launch": 30.0,
                     "fit.next": 0.0, "fit.log": 10.0, "fit.eval": 0.0, "fit.save": 0.0,
                     "fit.profile": 0.0, "fit.chunk": 50.0, "enqueue": 20.0 - 8.0 + 30.0 + 50.0}
    assert rec.setup_s() == {"loop.eager": 0.03}


def test_record_function_inside_a_span_maps_inside_it():
    acts = [torch.profiler.ProfilerActivity.CPU]
    spans.start()
    with torch.profiler.profile(activities=acts) as prof:
        with spans.span("outer"):
            with torch.profiler.record_function("inner"):
                torch.ones(64).sum()
    rec = spans.stop()
    t0 = prof.profiler.kineto_results.trace_start_ns()
    inner = [e for e in prof.events() if e.name == "inner"]
    assert len(inner) == 1
    [(a, b)] = rec.on_trace("outer", t0)
    assert a <= inner[0].time_range.start
    assert inner[0].time_range.end <= b
    assert rec.outside_ms([(inner[0].time_range.start, inner[0].time_range.end)], "outer",
                          t0) == 0.0


def _loop_chunk(record: bool):
    device = torch.device("cpu")
    cfg = _loop_cfg()
    cfg.device = "cpu"
    state, (chunk,) = _loop_state(device), _loop_chunks(device, 1)
    gen = torch.Generator().manual_seed(7)
    loop = make_train_loop(cfg, LOOP_K)
    if record:
        spans.start()
    metrics = loop(state, *chunk, LOOP_K, gen)
    return state, metrics, (spans.stop() if record else None)


def test_eager_loop_is_bit_equal_with_recording_on_and_off():
    s_off, m_off, _ = _loop_chunk(False)
    s_on, m_on, rec = _loop_chunk(True)
    for k in m_off:
        assert torch.equal(m_on[k], m_off[k]), k
    for attr in ("student", "discriminator"):
        a, b = getattr(s_on, attr).state_dict(), getattr(s_off, attr).state_dict()
        for k in b:
            assert torch.equal(a[k], b[k]), (attr, k)
    names = [s[0] for s in rec.spans]
    assert names == ["loop.eager"] + list(PHASES) * LOOP_K
    assert all(p == 0 for _, _, _, p in rec.spans[1:])
    assert rec.phases == {} and rec.stamps == []  # no marks on CPU tensors


def test_eval_sweep_records_each_frame(tmp_path):
    model = ResPSPNet(BASIC, (1, 1, 1, 1), 5, width_mult=0.25,
                      generator=torch.Generator().manual_seed(0)).eval()
    rng = np.random.default_rng(0)
    frames = [(rng.normal(size=(1, 64, 64, 3)).astype(np.float32),
               rng.integers(0, 5, (1, 64, 64)), np.array([[64, 64]]), [f"f{i}"])
              for i in range(2)]
    spans.start()
    evaluate_main(model, frames, 5, out_size=(64, 64), output_dir=str(tmp_path))
    rec = spans.stop()
    roots = rec.named("eval.frame")
    assert len(roots) == 3  # two frames, then the loader found empty
    kids = [[rec.spans[j][0] for j in rec.children(i)] for i in roots]
    assert kids[:2] == [["eval.next", "eval.wire", "eval.to_device", "eval.launch"]] * 2
    assert kids[2] == ["eval.next"]
    assert len(rec.spans) == 3 + 2 * 4 + 1  # nothing after the frames
    per_frame = rec.host_ms_a_frame()
    assert sorted(per_frame) == sorted(spans.FRAME_PARTS + ("eval.frame",))
    assert per_frame["eval.frame"] >= sum(per_frame[k] for k in spans.FRAME_PARTS)


def test_fit_with_profile_dir_records_until_its_window_closes(tmp_path, caplog, monkeypatch):
    """The profiler's window is step 10 (the run's first + 9): the record
    ends at the start of the chunk after it, steps 11-12, and is logged
    there, once. A second `fit` cut by an error stops its recording and
    logs nothing."""
    from test_torch_port_trainer import _cfg

    from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
    from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

    crop = (96, 96)  # no D, which needs 256² and would make the test slow
    cfg = _cfg(tmp_path, unroll_steps=2, num_steps=12, input_size=crop, ho=False,
               profile_dir=str(tmp_path / "prof"), profile_steps=1)
    spans.start()
    trainer = KDTrainer(cfg)
    outer = spans.stop()
    assert [s[0] for s in outer.spans] == ["trainer.init"]
    logged = []
    log_spans = trainer._log_spans
    monkeypatch.setattr(trainer, "_log_spans", lambda rec: (logged.append(rec), log_spans(rec)))
    with caplog.at_level(logging.INFO):
        trainer.fit(list(batch_iterator(SyntheticSegDataset(12, crop, seed=0), 1,
                                        shuffle=False)))
    assert not spans.recording() and len(logged) == 1
    lines = [r.getMessage() for r in caplog.records if r.getMessage().startswith("spans:")]
    assert len(lines) == 1 and "loop.eager" in lines[0]
    assert "0 teacher ABNs fused" in lines[0]  # a CPU teacher stays unfused
    rec = logged[0]
    assert rec.counters["teacher.fused_abn"] == 0
    roots = [i for i in rec.named("fit.chunk") if rec.spans[i][3] < 0]
    assert len(roots) == 6  # steps 1-10 in 5 chunks, then the next one's wait
    assert [rec.spans[j][0] for j in rec.children(roots[-1])] == ["fit.next"]
    assert len(rec.named("loop.eager")) == 5 and rec.setup_s()["loop.eager"] > 0

    def batches():
        yield from batch_iterator(SyntheticSegDataset(1, crop, seed=1), 1, shuffle=False)
        raise OSError("the loader failed")

    with pytest.raises(OSError, match="the loader failed"):
        trainer.fit(batches())
    assert not spans.recording() and len(logged) == 1


_MS = 1_000_000  # ns
_T0 = 10**18  # the profiler's trace start on the host clock, ns


def test_record_reads_a_hand_made_train_record():
    def at(a, b):  # ms from the trace's start
        return _T0 + int(a * _MS), _T0 + int(b * _MS)

    rec = spans.Record(spans=[
        ("trainer.init", *at(-9000, -5000), -1),          # 0
        ("fit.chunk", *at(-5000, -4000), -1),             # 1: eager
        ("loop.eager", *at(-5000, -4000), 1),
        ("teacher_forward", *at(-5000, -4900), 2),
        ("teacher_forward", *at(-4500, -4400), 2),
        ("fit.chunk", *at(-3000, -1000), -1),             # 5: capture, then its replay
        ("loop.capture", *at(-3000, -2000), 5),
        ("teacher_forward", *at(-3000, -2900), 6),
        ("teacher_forward", *at(-2500, -2400), 6),
        ("loop.launch", *at(-1500, -1200), 5),
        ("fit.chunk", *at(0, 10), -1),                    # 10: a replay
        ("fit.next", *at(0, 0.5), 10),
        ("loop.stage", *at(0.6, 0.9), 10),
        ("loop.stage.wait", *at(0.7, 0.8), 12),
        ("loop.launch", *at(1, 3), 10),
        ("fit.log", *at(4, 9), 10),
        ("fit.chunk", *at(20, 30), -1),                   # 16: an eager tail
        ("loop.eager", *at(20, 30), 16),
        ("teacher_forward", *at(20, 25), 17),
        ("kernels.load", *at(21, 22), 18),
    ], counters={"kernels.built": 6},
        phases={"teacher_forward": [90.0, 80.0, 5.0, 6.0, 5.0, 7.0, 50.0],
                "d_loss_and_grad": [1.0, 1.0, 2.0]})
    # 2 eager steps lead the stamps, 1 follows the replays: dropped
    assert rec.replayed_phases() == {"teacher_forward": [5.0, 6.0, 5.0, 7.0],
                                     "d_loss_and_grad": [1.0, 1.0, 2.0]}
    assert rec.device_ms_a_step() == {"teacher_forward": 5.5, "d_loss_and_grad": 1.0}
    assert rec.replayed_chunks() == [10]
    chunk = rec.host_ms_a_chunk()
    # the chunk's self time: 10 − 0.5 − 0.3 − 2 − 5
    assert abs(chunk["fit.chunk"] - 2.2) < 1e-9
    assert abs(chunk["enqueue"] - (0.3 - 0.1 + 2.0 + 2.2)) < 1e-9
    assert abs(chunk["fit.next"] - 0.5) < 1e-9 and abs(chunk["fit.log"] - 5.0) < 1e-9
    assert rec.setup_s() == {"trainer.init": 4.0, "loop.eager": 1.01, "loop.capture": 1.0,
                             "kernels.load": 0.001}
    # on the profiler's clock: one launch inside the replay's span, one 0.2 ms past it
    assert rec.on_trace("loop.launch", _T0) == [(-1.5e6, -1.2e6), (1e3, 3e3)]
    assert rec.outside_ms([(1_500.0, 1_600.0)], "loop.launch", _T0) == 0.0
    assert abs(rec.outside_ms([(1_500.0, 1_600.0), (2_950.0, 3_200.0)], "loop.launch", _T0)
               - 0.2) < 1e-9
    # nothing to read
    bare = spans.Record()
    assert bare.replayed_phases() == {} and bare.device_ms_a_step() == {}
    assert bare.host_ms_a_chunk() == {} and bare.setup_s() == {}
    assert bare.outside_ms([(0.0, 1.0)], "loop.launch", _T0) == math.inf


def test_record_reads_a_hand_made_eval_record():
    def at(a, b):  # µs from the trace's start
        return _T0 + a * 1_000, _T0 + b * 1_000

    rec = spans.Record(spans=[
        ("eval.frame", *at(0, 400), -1),       # 0
        ("eval.next", *at(0, 10), 0),
        ("eval.wire", *at(10, 150), 0),
        ("eval.to_device", *at(150, 250), 0),
        ("eval.launch", *at(250, 350), 0),
        ("eval.frame", *at(400, 410), -1),     # 5: the loader empty
        ("eval.next", *at(400, 410), 5),
    ])
    assert rec.host_ms_a_frame() == {"eval.next": 0.01, "eval.wire": 0.14,
                                     "eval.to_device": 0.1, "eval.launch": 0.1,
                                     "eval.frame": 0.4}
    # the device idle over (100, 300) µs: eval.to_device covers 150-250,
    # eval.launch 250-300
    gaps = [(100.0, 300.0)]
    assert rec.idle_share(gaps, "eval.to_device", _T0) == 0.5
    assert rec.idle_share(gaps, "eval.launch", _T0) == 0.25
    assert rec.idle_share([(100.0, 200.0), (390.0, 405.0)], "eval.next", _T0) == 5 / 115
    assert rec.outside_ms([(160.0, 170.0), (161.0, 169.0)], "eval.to_device", _T0) == 0.0
    assert math.isnan(rec.idle_share([], "eval.to_device", _T0))
    assert spans.Record().host_ms_a_frame() == {}


# ---------------------------------------------------------------- the card
@pytest.fixture
def exact_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the mark kernel has no CPU mode")
    dev = torch.device("cuda")
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield dev
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def _card_run(dev, record: bool):
    """A warm-up chunk, a capture with its replay, then two timed replays;
    recording on from before the warm-up when `record`."""
    state, gen = _loop_state(dev), torch.Generator().manual_seed(3)
    chunks = _loop_chunks(dev, 4)
    loop = make_train_loop(_loop_cfg(), LOOP_K)
    if record:
        spans.start()
    out = [loop(state, *chunks[0], LOOP_K, gen), loop(state, *chunks[1], LOOP_K, gen)]
    torch.cuda.synchronize()
    if record:
        spans.stop()
        spans.start()  # the graph's stamps only: its marks outlive a stop
    ms = []
    for c in chunks[2:]:
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        # the card busy while the host stages and launches the replay, so
        # the events time the device's work alone
        torch.cuda._sleep(100_000_000)
        a.record()
        out.append(loop(state, *c, LOOP_K, gen))
        b.record()
        torch.cuda.synchronize()
        ms.append(a.elapsed_time(b))
    rec = spans.stop() if record else None
    assert (loop.captures, loop.replays) == (1, 3)
    return state, out, ms, rec


@pytest.mark.cuda
def test_replay_marks_split_the_step_and_change_nothing(exact_cuda):
    rings = dict(spans._rings)
    s_off, out_off, _, _ = _card_run(exact_cuda, False)
    assert spans._rings == rings  # recording off allocates no ring
    s_on, out_on, ms, rec = _card_run(exact_cuda, True)
    # 2 stamps × 3 phases × unroll steps per replay, in order
    assert len(rec.stamps) == 2 * len(PHASES) * LOOP_K * 2
    want = [(p, e) for _ in range(2 * LOOP_K) for p in PHASES for e in (False, True)]
    assert [(n, e) for n, e, _ in rec.stamps] == want
    for p in PHASES:
        assert len(rec.phases[p]) == 2 * LOOP_K and all(v > 0 for v in rec.phases[p])
    for r, replay_ms in enumerate(ms):
        steps = range(r * LOOP_K, (r + 1) * LOOP_K)
        phase_ms = sum(rec.phases[p][i] for p in PHASES for i in steps)
        assert abs(phase_ms - replay_ms) <= 0.05 * replay_ms, (phase_ms, replay_ms)
    for a, b in zip(out_on, out_off):
        for k in b:
            assert torch.equal(a[k], b[k]), k
    for attr in ("student", "discriminator"):
        a, b = getattr(s_on, attr).state_dict(), getattr(s_off, attr).state_dict()
        for k in b:
            assert torch.equal(a[k], b[k]), (attr, k)
