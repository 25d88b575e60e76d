"""capture_ms.train: the multi-step loop's counter `TrainLoop.capture_ms`,
the host time of the capture of its CUDA graph, read after set-up."""


def read(run):
    v = run.get("capture_ms")
    return v if v else None
