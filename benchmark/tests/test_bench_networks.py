"""Networks found by the `arch` a configuration's slot names, and span
records for the readers that ask for them.

Each `arch` of `benchmark/configs/*.json` is a file `benchmark/networks/
<arch>.py`. The counts of the cells are pinned to the values the harness
gave before the lookup existed (the reference's FLOPs on fake tensors and
the shapes of its heads and logits), at the toy sizes of `conftest.toy_cell`
and at the cells' own sizes. A copy of `resnet18.py` under a new name runs
the toy cells with nothing else changed; a student with one head is trained
on CE(main↑) alone; a network file may make its own seeded state; a reader
with `SPANS = True` gets the port's `Record` in a traced run, and a cell
without one records nothing."""

from __future__ import annotations

import json
import shutil

import pytest
import torch

from benchmark import harness, inputs
from benchmark import run as bench_run
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train
from benchmark.reference import archs, counts, kd_step, nets, precision, weights
from benchmark.tests.conftest import toy_cell

SEED = 2 ** 31 + 12289
TRAIN, VAL = "psp_r18_kd.train_b8_512", "psp_r18_kd.val_1024x2048"

# the harness's counts before networks were looked up by name
PINNED_TRAIN = {
    ("psp_r18_kd", "toy"): (686539080704.0, [(4, 19, 33, 33), (4, 19, 33, 33)]),
    ("psp_r18_kd", "full"): (7702573484032.0, [(8, 19, 65, 65), (8, 19, 65, 65)]),
    ("espnet_c_kd", "toy"): (100116426752.0, [(4, 11, 16, 20), (4, 11, 32, 40)]),
    ("espnet_c_kd", "full"): (3141156716032.0, [(8, 11, 45, 60), (8, 11, 90, 120)]),
}
PINNED_VAL = {"toy": (9420858880.0, (1, 19, 17, 33)),
              "full": (996671489536.0, (1, 19, 129, 257))}


def _configs():
    return sorted(p.stem for p in (harness.BENCH_DIR / "configs").glob("*.json"))


@pytest.mark.parametrize("config", _configs())
def test_every_arch_of_the_configs_resolves(config):
    from structure_knowledge_distillation_tpu_torch.config import TrainConfig

    body = harness.load_json(harness.BENCH_DIR / "configs" / f"{config}.json")
    classes = body["recipe"]["classes"]
    fields = {}
    for slot in ("teacher", "student"):
        part = body[slot]
        net = archs.network(part["arch"])
        for fn in ("spec", "forward", "program_fields", "served"):
            assert callable(getattr(net, fn)), (part["arch"], fn)
        spec = archs.spec_of(part, classes)
        assert spec["arch"] == part["arch"]
        fields.update(net.program_fields(part))
    cfg = TrainConfig(classes_num=classes, device="cpu", **fields)
    assert cfg.student_arch == fields["student_arch"]


def _train_counts(config: dict, traffic: dict) -> dict:
    return counts.train_step_counts(train.specs_of(config), kd_step.Recipe(config["recipe"]),
                                    traffic["batch"], tuple(traffic["crop"]))


@pytest.mark.parametrize("size", ["toy", "full"])
def test_train_counts_are_the_pinned_ones(size):
    cell = toy_cell(TRAIN) if size == "toy" else harness.Cell(TRAIN)
    got = _train_counts(cell.config, cell.traffic)
    assert (got["flops_per_step"], got["heads"]) == PINNED_TRAIN[("psp_r18_kd", size)]


@pytest.mark.parametrize("size", ["toy", "full"])
def test_espnet_train_counts_are_the_pinned_ones(size):
    config = harness.load_json(harness.BENCH_DIR / "configs" / "espnet_c_kd.json")
    traffic = harness.load_json(harness.BENCH_DIR / "traffic" / "train_b8_360x480.json")
    if size == "toy":
        config["teacher"]["layers"] = [1, 1, 1, 1]
        traffic.update(batch=4, crop=[128, 160])
    got = _train_counts(config, traffic)
    assert (got["flops_per_step"], got["heads"]) == PINNED_TRAIN[("espnet_c_kd", size)]


@pytest.mark.parametrize("size", ["toy", "full"])
def test_val_counts_are_the_pinned_ones(size):
    cell = toy_cell(VAL) if size == "toy" else harness.Cell(VAL)
    got = counts.eval_frame_counts(eval_driver.spec_of(cell.config),
                                   tuple(cell.traffic["frame"]))
    assert (got["flops_per_frame"], got["logits"]) == PINNED_VAL[size]


@pytest.fixture
def networks_dir(tmp_path, monkeypatch):
    """A networks directory of the benchmark's files in a temporary place,
    with `r18_copy.py`, a copy of `resnet18.py`, beside them."""
    d = tmp_path / "networks"
    shutil.copytree(archs.NETWORKS_DIR, d, ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(d / "resnet18.py", d / "r18_copy.py")
    monkeypatch.setattr(archs, "NETWORKS_DIR", d)
    return d


def _spy(monkeypatch, arch: str) -> dict:
    """Count the calls of the network file's functions, loaded from where
    the lookup finds it."""
    net = archs.network(arch)
    calls = {}
    for fn in ("spec", "forward", "program_fields", "served"):
        orig = getattr(net, fn)

        def counted(*a, _orig=orig, _fn=fn, **k):
            calls[_fn] = calls.get(_fn, 0) + 1
            return _orig(*a, **k)

        monkeypatch.setattr(net, fn, counted)
    return calls


def test_a_copied_network_file_runs_the_toy_cells(networks_dir, cpu_card, monkeypatch):
    assert archs.network("r18_copy").__file__ == str(networks_dir / "r18_copy.py")
    calls = _spy(monkeypatch, "r18_copy")
    for name, driver in ((TRAIN, train), (VAL, eval_driver)):
        cell = toy_cell(name)
        cell.config["student"]["arch"] = "r18_copy"
        rec = driver.run(cell, SEED, 1.0, False, "cpu")
        out, checks = bench_run.result(cell, rec, False)
        assert out["correct"], (name, checks)
    assert calls["spec"] >= 2 and calls["forward"] > 0
    assert calls["program_fields"] == 1 and calls["served"] == 1


ONE_HEAD = '''
from benchmark.reference import nets


def spec(slot, classes):
    return {"kind": "one_head", "classes": classes, "convs": [("head", classes, 3, 3, True)],
            "bns": [], "classifiers": ["head"]}


def forward(c, spec, x):
    logits = nets.conv(c, x, "head", 8, 1)
    return logits, None, logits


def program_fields(slot):
    return {"student_arch": "resnet18"}


def served(slot, classes, device):
    raise NotImplementedError
'''


def test_a_student_with_one_head_is_trained_on_its_main_head(networks_dir):
    (networks_dir / "one_head.py").write_text(ONE_HEAD)
    c, n, size = 5, 2, (64, 64)
    specs = {"teacher": archs.spec_of({"arch": "pspnet", "block": "bottleneck",
                                       "layers": [1, 1, 1, 1]}, c),
             "student": archs.spec_of({"arch": "one_head"}, c),
             "disc": nets.disc_spec(c, 33, 16)}
    g = torch.Generator().manual_seed(3)
    st = {k: weights.make_state(v, g, "cpu") for k, v in specs.items()}
    x = inputs.images(inputs.make_generator("cpu", 3, 0), n, size, {}, "cpu")
    y = inputs.labels(inputs.make_generator("cpu", 3, 1), n, size, c, {}, "cpu").long()
    recipe = kd_step.Recipe(dict(classes=c, pi=False, pa=False, ho=False))
    out = kd_step.ref_steps(specs, {**st, "g_buf": {}, "d_buf": {}}, [(x, y)], recipe,
                            precision.Exact(), lambda s: torch.rand(s), 0)
    main = nets.conv(nets.Ctx(dict(st["student"]), precision.Exact(), True), x, "head", 8, 1)
    ce = float(kd_step._ce(nets.up(main, size), y, 255))
    loss = out["losses"][0]
    assert loss["mc_loss"] == pytest.approx(ce, rel=1e-6)
    assert loss["g_loss"] == loss["mc_loss"]
    assert set(out["first_grads"]["student"]) == {"head.weight", "head.bias"}
    got = counts.train_step_counts(specs, recipe, n, size)
    assert got["heads"] == [(n, c, 8, 8)]


OWN_STATE = '''
import torch


def spec(slot, classes):
    return {"kind": "own_state", "classes": classes}


def make_state(spec, gen, device):
    return {"proj.weight": torch.randn(spec["classes"], 3, generator=gen, device=device)}
'''


def test_a_network_file_may_make_its_own_state(networks_dir):
    """A network whose parameters are not convolutions, ABNs and PReLUs
    (linear layers, layer norms) makes its seeded state in its own file."""
    (networks_dir / "own_state.py").write_text(OWN_STATE)
    spec = archs.spec_of({"arch": "own_state"}, 5)
    got = weights.make_state(spec, torch.Generator().manual_seed(1), "cpu")
    want = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    assert list(got) == ["proj.weight"] and torch.equal(got["proj.weight"], want)


SPANS_READER = '''
SPANS = True


def read(run):
    rec = run.get("spans")
    return None if rec is None else float(len(rec.named("{span}")))
'''


def _cell_with_reader(name: str, metric: str, moves: str):
    manifest = json.loads(json.dumps(harness.load_json(harness.REPO / "BENCHMARK.json")))
    manifest["per_layer"] = [{"name": metric, "unit": "1", "better": "higher",
                              "source": "program_span", "layer": "test", "moves": moves,
                              "workloads": [name]}]
    cell = toy_cell(name)
    cell.manifest = manifest
    cell.per_layer = manifest["per_layer"]
    return cell


@pytest.mark.parametrize("name,span,moves", [(VAL, "eval.frame", "eval_frames_per_s"),
                                             (TRAIN, "trainer.init", "train_images_per_s")])
def test_a_spans_reader_gets_the_record(name, span, moves, tmp_path, cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.utils import spans

    d = tmp_path / "metrics"
    d.mkdir()
    (d / "spans_probe.py").write_text(SPANS_READER.format(span=span))
    monkeypatch.setattr(harness, "METRICS_DIR", d)
    cell = _cell_with_reader(name, "spans_probe", moves)
    driver = train if name == TRAIN else eval_driver
    rec = driver.run(cell, SEED, 1.0, True, "cpu")
    assert isinstance(rec["spans"], spans.Record)
    assert not spans.recording()
    metrics = harness.read_per_layer(cell, rec)
    assert metrics["spans_probe"]["value"] >= 1
    if name == VAL:  # the window's frames, and the wait that ends it; no warm-up frame
        assert len(rec["spans"].named(span)) == rec["frames"] + 1
    t = rec["trace"]
    if t is not None:  # the spans map onto the profiled stretch's clock
        a0, b0 = min(a for _, a, _ in t.host), max(b for _, _, b in t.host)
        assert any(a0 <= a <= b0 for a, _ in rec["spans"].on_trace(span, t.start_ns))


def test_a_cell_without_a_spans_reader_records_none(cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.utils import spans

    started = []
    monkeypatch.setattr(spans, "start", lambda: started.append(1))
    cell = toy_cell(VAL)
    assert not harness.wants_spans(cell)
    rec = eval_driver.run(cell, SEED, 1.0, True, "cpu")
    assert rec["spans"] is None and not started


def test_a_window_that_raises_stops_the_recording(tmp_path, cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.training import evaluate
    from structure_knowledge_distillation_tpu_torch.utils import spans

    d = tmp_path / "metrics"
    d.mkdir()
    (d / "spans_probe.py").write_text(SPANS_READER.format(span="eval.frame"))
    monkeypatch.setattr(harness, "METRICS_DIR", d)
    calls = []

    def failing(*a, **k):  # the warm-up sweep runs, the window raises
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("the window failed")
        return evaluate_main(*a, **k)

    evaluate_main = evaluate.evaluate_main
    monkeypatch.setattr(evaluate, "evaluate_main", failing)
    cell = _cell_with_reader(VAL, "spans_probe", "eval_frames_per_s")
    with pytest.raises(RuntimeError, match="the window failed"):
        eval_driver.run(cell, SEED, 1.0, True, "cpu")
    assert len(calls) == 2 and not spans.recording()
