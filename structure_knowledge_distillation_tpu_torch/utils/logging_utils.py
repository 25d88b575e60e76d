"""File + console logging (counterpart of
`structure_knowledge_distillation_tpu/utils/logging_utils.py`, reference
utils/utils.py:40-51)."""

from __future__ import annotations

import logging
import os
import time

__all__ = ["log_init"]


def log_init(log_dir: str, name: str = "log", level: int = logging.INFO) -> None:
    """Send the root logger to `<log_dir>/<name>_<time>.log` (replacing its
    handlers) and to the console."""
    os.makedirs(log_dir, exist_ok=True)
    stamp = time.strftime("%Y-%m-%d_%H:%M:%S", time.localtime())
    logging.basicConfig(
        filename=os.path.join(log_dir, f"{name}_{stamp}.log"),
        format="%(asctime)s - %(pathname)s[line:%(lineno)d] - %(levelname)s: %(message)s",
        level=level,
        force=True,
    )
    console = logging.StreamHandler()
    console.setLevel(logging.INFO)
    console.setFormatter(logging.Formatter("%(levelname)-8s %(message)s"))
    logging.getLogger("").addHandler(console)
