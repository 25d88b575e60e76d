"""roofline.upsampled_ce.train: the upsampled cross-entropy's share of its
roofline in the profiled stretch.

The least time of the function at the cell's shapes, summed over the steps
profiled, over the profiled device time of the kernels that implement it
(matched by `PATTERN`). Per step, forward and backward; the DSN loss is one
two-head pass when the student's heads agree in shape (K4/K5), else one
pass per head (K2/K3). Per pass and head, with N·C·h·w logits upsampled to
N·H·W labels of which V are not ignored:
  * forward: bytes = logits + 4-byte labels + 4; FLOPs = the separable
    resize 3·N·C·H·(w + W) + 3·C·V (max, exp, sum of the log-softmax);
  * backward: bytes = 2·logits + labels; FLOPs = 2·resize + 5·C·V.
The least time of a pass is the larger of its bytes at 3.35 TB/s and its
FLOPs at 67 TFLOP/s (float32 outside the tensor cores: the function's
arithmetic is f32 lerps and exponentials). H100 SXM data sheet, 700 W."""

import math

PATTERN = r"\bce_(fwd_interval|reduce|bwd_interval|bwd_combine)_kernel\b"
HBM = 3.35e12
F32 = 67e12
LOGIT_BYTES = 2  # bf16 logits


def least_s_per_step(heads, crop, valid):
    h_out, w_out = crop
    groups = [heads] if heads[0] == heads[-1] else [[h] for h in heads]
    total = 0.0
    for group in groups:
        logits = sum(math.prod(s) for s in group) * LOGIT_BYTES
        n = group[0][0]
        labels = n * h_out * w_out * 4
        resize = sum(3 * s[0] * s[1] * h_out * (s[3] + w_out) for s in group)
        ce = sum(s[1] for s in group) * valid
        total += max((logits + labels + 4) / HBM, (resize + 3 * ce) / F32)
        total += max((2 * logits + labels) / HBM, (2 * resize + 5 * ce) / F32)
    return total


def read(run):
    t = run.get("trace")
    if t is None or not run.get("heads") or not t.steps:
        return None
    dev_s = t.time_us(PATTERN) / 1e6
    if dev_s <= 0:
        return None
    least = t.steps * least_s_per_step(run["heads"], run["crop"], run["valid_pixels"])
    return 100.0 * least / dev_s
