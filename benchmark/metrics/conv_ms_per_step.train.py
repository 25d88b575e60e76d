"""conv_ms_per_step.train: profiled device milliseconds per step in
convolution kernels (cuDNN's forward, data- and weight-gradient kernels)
and cuDNN's NCHW<->NHWC layout transposes around them, matched by name."""

PATTERN = (r"(?i)(conv|fprop|dgrad|wgrad|implicit_gemm|implicit_convolve"
           r"|nchwToNhwc|nhwcToNchw)")


def read(run):
    t = run.get("trace")
    if t is None or not t.steps:
        return None
    us = t.time_us(PATTERN)
    return us / 1e3 / t.steps if us > 0 else None
