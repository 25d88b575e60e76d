"""device_idle.train: the share of the profiled stretch of the window in
which no kernel, copy or set ran on the card: 1 − (union of the device's
intervals) / (the stretch's wall time on the host clock), in percent."""


def read(run):
    t = run.get("trace")
    if t is None or t.wall_s <= 0 or not t.device:
        return None
    return 100.0 * (1.0 - t.busy_us() / 1e6 / t.wall_s)
