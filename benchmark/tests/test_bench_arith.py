"""The benchmark's arithmetic on hand-made intervals and counts: the busy
union, idle gaps and the breakdown, each per-layer reader, the leaves'
gaps, the verdict and the val sweep's mismatch share."""

from __future__ import annotations

import math
import statistics

import numpy as np
import pytest

from benchmark import harness
from benchmark.drivers import eval as eval_driver


def _trace(device, host=(), wall_s=1e-3, steps=0, frames=0):
    return harness.Trace(list(device), list(host), wall_s, steps=steps, frames=frames)


def test_union_merges_overlaps_and_keeps_gaps():
    assert harness.union_us([(0, 10), (5, 15), (20, 30), (30, 31)]) == 26
    assert harness.union_us([]) == 0


def test_idle_gaps_and_breakdown_name_the_host():
    t = _trace([("k1", 0, 10), ("k2", 40, 50), ("k1", 55, 60)],
               host=[("fit", 0, 100), ("cudaStreamSynchronize", 12, 38)])
    assert harness.idle_gaps(t) == [(10, 40), (50, 55)]
    b = harness.breakdown(t)
    assert b["device_ops"][0] == ["k1", pytest.approx(15e-6)]
    assert b["idle_gaps"] == [["host: cudaStreamSynchronize", pytest.approx(30e-6)],
                              ["host: fit", pytest.approx(5e-6)]]


def test_device_idle_and_time_by_pattern():
    read = harness.load_reader("device_idle.train")
    t = _trace([("a", 0, 250), ("b", 500, 750)], wall_s=1e-3, steps=2)
    assert read({"trace": t}) == pytest.approx(50.0)
    assert read({"trace": None}) is None
    conv = harness.load_reader("conv_ms_per_step.train")
    t = _trace([("sm90_xmma_fprop_implicit_gemm_bf16", 0, 1000),
                ("void cudnn::engines_precompiled::nchwToNhwcKernel<float>", 1000, 1500),
                ("elementwise_kernel", 1500, 4000)], steps=2)
    assert conv({"trace": t}) == pytest.approx(0.75)
    assert conv({"trace": _trace([("elementwise_kernel", 0, 1)], steps=1)}) is None


def test_roofline_of_the_upsampled_ce():
    mod = harness.load_reader("roofline.upsampled_ce.train").__globals__
    heads = [(8, 19, 65, 65), (8, 19, 65, 65)]
    least = mod["least_s_per_step"](heads, (512, 512), 1e6)
    logits = 2 * 8 * 19 * 65 * 65 * 2
    resize = 2 * 3 * 8 * 19 * 512 * (65 + 512)
    labels = 8 * 512 * 512 * 4
    want = (max((logits + labels + 4) / 3.35e12, (resize + 3 * 38 * 1e6) / 67e12)
            + max((2 * logits + labels) / 3.35e12, (2 * resize + 5 * 38 * 1e6) / 67e12))
    assert least == pytest.approx(want)
    # heads that differ in shape are priced one pass each
    two = mod["least_s_per_step"]([(8, 11, 45, 60), (8, 11, 90, 120)], (360, 480), 1e6)
    one = mod["least_s_per_step"]([(8, 11, 45, 60)] * 2, (360, 480), 1e6)
    assert two > 0 and two != one
    t = _trace([("ce_fwd_interval_kernel<bf16>", 0, 10), ("ce_bwd_interval_kernel", 10, 40),
                ("ce_reduce_kernel", 40, 41), ("ce_bwd_combine_kernel", 41, 45),
                ("other", 45, 100)], steps=1)
    read = harness.load_reader("roofline.upsampled_ce.train")
    got = read({"trace": t, "heads": heads, "crop": (512, 512), "valid_pixels": 1e6})
    assert got == pytest.approx(100 * least / 45e-6)
    assert read({"trace": _trace([("other", 0, 1)], steps=1), "heads": heads,
                 "crop": (512, 512), "valid_pixels": 1.0}) is None


def test_roofline_of_k1():
    read = harness.load_reader("roofline.upsampled_argmax.eval")
    least = read.__globals__["least_s_per_frame"]((1, 19, 129, 257), (1024, 2048))
    nbytes = 19 * 129 * 257 * 4 + 1024 * 2048 * 4
    flops = 19 * 1024 * (3 * 257 + 3 * 2048 + 2048)
    assert least == pytest.approx(max(nbytes / 3.35e12, flops / 67e12))
    t = _trace([("void upsampled_argmax_kernel<float>", 0, 50)], frames=2)
    got = read({"trace": t, "logits": (1, 19, 129, 257), "frame": (1024, 2048)})
    assert got == pytest.approx(100 * 2 * least / 50e-6)


def test_mfu_and_copies_and_counters():
    mfu = harness.load_reader("mfu.train")
    t = _trace([("k", 0, 1)], wall_s=4.0, steps=2)
    assert mfu({"flops_per_step": 989e12, "trace": t}) == pytest.approx(50.0)
    assert mfu({"trace": t}) is None and mfu({"flops_per_step": 1.0, "trace": None}) is None
    mfu_e = harness.load_reader("mfu.eval")
    t = _trace([("k", 0, 1)], wall_s=2.0, frames=1)
    assert mfu_e({"flops_per_frame": 495e12, "trace": t}) == pytest.approx(50.0)
    h2d = harness.load_reader("h2d_ms.eval")
    t = _trace([("Memcpy HtoD (Pinned -> Device)", 0, 500), ("k", 500, 900)], frames=2)
    assert h2d({"trace": t}) == pytest.approx(0.25)
    cap = harness.load_reader("capture_ms.train")
    assert cap({"capture_ms": 812.5}) == 812.5 and cap({"capture_ms": 0.0}) is None


def test_leaf_gap_uses_the_larger_of_leaf_and_median():
    ref = {"a": 1.0, "b": 2.0, "c": 4.0, "tiny": 1e-9}
    prog = {"a": 1.1, "b": 2.0, "c": 4.0, "tiny": 2e-9}
    assert harness.leaf_gap(prog, ref, {"a", "b", "c"}) == pytest.approx(0.05)
    # the tiny leaf's gap is measured against the median leaf's norm
    assert harness.leaf_gap(prog, ref, set(ref)) == pytest.approx(0.1 / 1.5)
    assert harness.leaf_gap(prog, ref, {"a", "b", "c"}, statistics.median) == 0.0
    assert math.isnan(harness.leaf_gap(prog, ref, set()))


def test_verdict_needs_every_limited_number_finite_and_under():
    ok, checks = harness.verdict({"x": 0.1, "y": 0.2, "z": 9.0}, {"x": 0.5, "y": 0.5})
    assert ok and set(checks) == {"x", "y"}
    assert not harness.verdict({"x": 0.6}, {"x": 0.5})[0]
    assert not harness.verdict({"x": math.nan}, {"x": 0.5})[0]
    assert not harness.verdict({}, {"x": 0.5})[0]
    assert not harness.verdict({"x": 0.1}, {})[0]


def test_mismatch_share_counts_moved_pixels():
    ref = np.array([[5, 1], [0, 4]])
    assert eval_driver.mismatch_share(ref.copy(), ref) == 0.0
    moved = np.array([[4, 2], [0, 4]])
    assert eval_driver.mismatch_share(moved, ref) == pytest.approx(0.1)
    assert eval_driver.mismatch_share(np.array([[5, 1], [0, 5]]), ref) == math.inf


def test_forbidden_names_are_compared_whole():
    import sys

    assert "structure_knowledge_distillation_tpu_torch" not in harness.FORBIDDEN
    before = harness.forbidden_modules()
    sys.modules["structure_knowledge_distillation_tpu_torch_probe"] = object()
    try:
        assert harness.forbidden_modules() == before
    finally:
        del sys.modules["structure_knowledge_distillation_tpu_torch_probe"]
