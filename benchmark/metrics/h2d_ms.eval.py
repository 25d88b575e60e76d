"""h2d_ms.eval: profiled device milliseconds per frame of host-to-device
copies (the frame and its labels crossing from pinned memory)."""

PATTERN = r"Memcpy HtoD"


def read(run):
    t = run.get("trace")
    if t is None or not t.frames:
        return None
    us = t.time_us(PATTERN)
    return us / 1e3 / t.frames if us > 0 else None
