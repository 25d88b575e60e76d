"""The harness and every file it runs import with JAX, Flax and the JAX
package blocked (top-level names compared whole), and a run on a host
without enough cards exits without a result instead of using the CPU."""

from __future__ import annotations

import os
import subprocess
import sys
import textwrap

import pytest

from benchmark import harness
from benchmark.reference import archs

BLOCKER = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = {"jax", "jaxlib", "flax", "structure_knowledge_distillation_tpu"}

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked: {name}")
            return None

    sys.meta_path.insert(0, Block())
""")


def _python(code: str) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=str(harness.REPO))
    return subprocess.run([sys.executable, "-c", BLOCKER + code], capture_output=True,
                          text=True, cwd=harness.REPO, env=env, timeout=300)


def test_everything_the_benchmark_runs_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, pathlib, sys
        from benchmark import harness, run, checks, inputs
        from benchmark.drivers import train, eval as ev
        from benchmark.reference import counts, flops, kd_step, nets, precision, weights
        for m in harness.load_json(harness.REPO / "BENCHMARK.json")["per_layer"]:
            harness.load_reader(m["name"])
        # the program's modules the drivers reach
        from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer
        from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main
        found = harness.forbidden_modules()
        assert not found, found
        print("clean", len(sys.modules))
    """)
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "clean" in out.stdout


def test_the_reference_imports_nothing_of_the_program():
    """Nor does any network file: the port's module a network serves is
    imported when `served` is called."""
    code = textwrap.dedent("""
        import sys
        from benchmark.reference import archs, counts, flops, kd_step, nets, precision, weights
        files = sorted(archs.NETWORKS_DIR.glob("*.py"))
        for p in files:
            archs.network(p.stem)
        names = {m.split(".")[0] for m in sys.modules}
        assert "structure_knowledge_distillation_tpu_torch" not in names
        print("clean", len(files))
    """)
    out = _python(code)
    assert out.returncode == 0, out.stderr[-3000:]
    n_files = len(list(archs.NETWORKS_DIR.glob("*.py")))
    assert n_files >= 3 and out.stdout.split()[-2:] == ["clean", str(n_files)]


def test_no_card_means_no_result(monkeypatch, capsys):
    import torch

    from benchmark import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc = run.main(["--workload", "psp_r18_kd.train_b8_512", "--seed", "2147483651",
                   "--seconds", "1"])
    assert rc == run.EXIT_NO_CARD
    captured = capsys.readouterr()
    assert captured.out == ""
    assert "CUDA device" in captured.err


def test_too_few_cards_is_refused(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(harness.NoCard):
        harness.require_cuda(4)
    assert harness.require_cuda(1) == 1


def test_a_bare_directory_gives_no_result(tmp_path):
    """A directory with BENCHMARK.json and the benchmark's files, without the
    program, exits with an error and prints no result line."""
    import shutil

    shutil.copy(harness.REPO / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(harness.BENCH_DIR, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "psp_r18_kd.train_b8_512", "--seed", "5", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
