"""mfu.eval: the whole forward's share of the card's peak in the type the
convolutions run in. The served student is float32 with torch's default
cudnn.allow_tf32, so its convolutions run as TF32: 495 TFLOP/s (H100 SXM,
dense, 700 W). Numerator: the reference forward's FLOPs of one frame at the
cell's shape, times the frames of the profiled stretch of the window, over
its seconds (a synchronize at each end)."""

PEAK_FLOPS = 495e12


def read(run):
    t = run.get("trace")
    if t is None or not run.get("flops_per_frame") or not t.frames or t.wall_s <= 0:
        return None
    return 100.0 * run["flops_per_frame"] * t.frames / t.wall_s / PEAK_FLOPS
