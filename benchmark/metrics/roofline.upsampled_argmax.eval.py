"""roofline.upsampled_argmax.eval: K1's share of its roofline in the
profiled stretch: the least time of the align-corners upsample and
first-index argmax of each frame's (1, C, h, w) float32 logits to (H, W),
over the profiled device time of `PATTERN`.
  * bytes: the logits read once, the int32 class map written once;
  * FLOPs: C·H·(3·w + 3·W + W): a lerp (3) along H on the input's columns,
    one along W, and a compare per class and pixel.
The least time is the larger of the bytes at 3.35 TB/s and the FLOPs at
67 TFLOP/s (f32 outside the tensor cores). H100 SXM data sheet, 700 W."""

import math

PATTERN = r"\bupsampled_argmax_kernel\b"
HBM = 3.35e12
F32 = 67e12


def least_s_per_frame(logits, frame):
    n, c, h_in, w_in = logits
    h, w = frame
    nbytes = math.prod(logits) * 4 + n * h * w * 4
    flops = n * c * h * (3 * w_in + 3 * w + w)
    return max(nbytes / HBM, flops / F32)


def read(run):
    t = run.get("trace")
    if t is None or not t.frames or not run.get("logits"):
        return None
    dev_s = t.time_us(PATTERN) / 1e6
    if dev_s <= 0:
        return None
    return 100.0 * t.frames * least_s_per_frame(run["logits"], run["frame"]) / dev_s
