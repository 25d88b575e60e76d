"""BENCHMARK.json against the contract it is checked by: names, units, keys,
the metrics each cell reports, the four-chip share, and the files the
harness finds by name."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys

import pytest

from benchmark import harness

MANIFEST = harness.load_json(harness.REPO / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
METRIC_KEYS = {"name", "unit", "better", "source", "bound"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def test_top_level_keys_and_paths():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs", "workloads",
                             "end_to_end", "per_layer"}
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch")
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(MANIFEST["run_seconds"], int) and 1 <= MANIFEST["run_seconds"] <= 51
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MANIFEST[section]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n


def test_metric_names_are_unique_across_sections():
    names = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]]
    assert len(names) == len(set(names))


def test_end_to_end_metrics():
    e2e = MANIFEST["end_to_end"]
    assert 1 <= len(e2e) <= 4
    names = {m["name"] for m in e2e}
    assert "setup_s" in names
    for m in e2e:
        assert set(m) - {"workloads"} == METRIC_KEYS, m
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in e2e if m["name"] == "setup_s")["bound"] <= 0.25


def test_per_layer_metrics_and_what_they_move():
    cells = {w["name"] for w in MANIFEST["workloads"]}
    for m in MANIFEST["per_layer"]:
        assert set(m) == LAYER_KEYS | {"workloads"}, m
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200 and "\n" not in m["layer"]
        assert set(m["workloads"]) <= cells
        for cell in m["workloads"]:
            reported = {e["name"] for e in harness.Cell(cell, MANIFEST).end_to_end}
            assert m["moves"] in reported, (m["name"], cell)
        if m["name"].split(".")[0].endswith("roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for w in MANIFEST["workloads"]:
        cell = harness.Cell(w["name"], MANIFEST)
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2
        assert cell.per_layer


def test_cells_configs_and_chips():
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    pairs = set()
    for w in MANIFEST["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"]) and 1 <= len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(MANIFEST["workloads"]) // 4)
    used = {w["config"] for w in MANIFEST["workloads"]}
    assert used == set(configs)


def test_config_files():
    files = set()
    for c in MANIFEST["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["file"] not in files
        files.add(c["file"])
        body = harness.load_json(harness.REPO / c["file"])
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert body["assumed"]
        assert len(c["reduced"]) <= 16 and 1 <= len(c["why"]) <= 200


def test_files_the_harness_finds_by_name():
    bench = harness.BENCH_DIR
    for w in MANIFEST["workloads"]:
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert (bench / "limits" / f"{w['name']}.json").is_file(), w["name"]
    for m in MANIFEST["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    for root, _, names in os.walk(bench):
        for n in names:
            rel = os.path.relpath(os.path.join(root, n), harness.REPO)
            if "__pycache__" not in rel:
                assert PATH.match(rel), rel


def test_pin_host_holds_cpus_with_one_thread():
    """`pin_host(cpus)`: the last `cpus` CPUs and one torch thread; in a
    process of its own, since it holds the whole process."""
    code = ("import os, torch; from benchmark import harness; "
            "n = min(2, len(os.sched_getaffinity(0))); keep = harness.pin_host(n); "
            "print(keep == sorted(os.sched_getaffinity(0)), len(keep) == n, "
            "torch.get_num_threads())")
    env = dict(os.environ, PYTHONPATH=str(harness.REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=harness.REPO, env=env, timeout=300)
    assert out.stdout.split() == ["True", "True", "1"], out.stderr[-2000:]
