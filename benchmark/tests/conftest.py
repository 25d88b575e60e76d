"""Shared set-up of the benchmark's tests: the repository root on the path,
two torch threads, and toy versions of the cells for the CPU."""

from __future__ import annotations

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


@pytest.fixture(autouse=True)
def _two_threads():
    import torch

    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def cpu_card(monkeypatch):
    """The card's calls that the drivers make, as no-ops on the CPU."""
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 1)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a, **k: "cpu")


def toy_cell(name: str, compute_dtype: str = "float32"):
    """The cell `name` cut to a size the CPU runs in about a minute: the
    teacher (1, 1, 1, 1) deep, batch 4 at 256² (the discriminator at 33²),
    or 128 × 256 frames for the val sweep; widths as published."""
    from benchmark import harness

    cell = harness.Cell(name)
    if cell.traffic["kind"] == "eval":
        cell.config["student"]["layers"] = [1, 1, 1, 1]
        cell.traffic.update(frame=[128, 256], pool_frames=3, warmup_frames=1, trace_from=1,
                            trace_frames=2)
        return cell
    cell.config["teacher"]["layers"] = [1, 1, 1, 1]
    cell.config["compute_dtype"] = compute_dtype
    if cell.config["recipe"]["ho"]:
        cell.config["disc"]["imsize_for_adv"] = 33
        cell.traffic["crop"] = [256, 256]
    else:
        cell.traffic["crop"] = [128, 160]
    cell.traffic.update(batch=4, pool_chunks=3, trace_from=1, trace_chunks=1)
    return cell
