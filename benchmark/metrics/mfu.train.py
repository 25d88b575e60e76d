"""mfu.train: the whole step's share of the card's bf16 peak.

The reference step's FLOPs at the cell's shapes (`reference/counts.py`,
counted on fake tensors after the window, no recompute) times the steps of
the profiled stretch of the window, over its seconds (a synchronize at each
end), over 989 TFLOP/s (the H100 SXM's dense bf16 rate, at a
700 W power limit)."""

PEAK_FLOPS = 989e12


def read(run):
    t = run.get("trace")
    if t is None or not run.get("flops_per_step") or not t.steps or t.wall_s <= 0:
        return None
    return 100.0 * run["flops_per_step"] * t.steps / t.wall_s / PEAK_FLOPS
