"""Scalar metrics writer (JSONL) and the config dump.

Counterpart of `structure_knowledge_distillation_tpu/utils/metrics_writer.py`
(the reference's tensorboardX writer, utils/utils.py:53-61, without the
dependency), with the same rows: each line is
{"step": int, "wall_time": float, **scalars}.
"""

from __future__ import annotations

import json
import os
import time
from typing import Mapping

__all__ = ["MetricsWriter", "save_args"]


class MetricsWriter:
    """Appends one JSON line per `write` to `<log_dir>/<name>.jsonl`."""

    def __init__(self, log_dir: str, name: str = "scalars"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, f"{name}.jsonl")
        self._f = open(self.path, "a", buffering=1)

    def write(self, step: int, scalars: Mapping[str, float]) -> None:
        rec = {"step": int(step), "wall_time": time.time()}
        rec.update({k: float(v) for k, v in scalars.items()})
        self._f.write(json.dumps(rec) + "\n")

    def close(self) -> None:
        self._f.close()


def save_args(cfg, path: str) -> None:
    """Dump the config to args.txt (reference utils/utils.py:63-71)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        for key, val in vars(cfg).items():
            f.write(f"{key} : {val}\n")
