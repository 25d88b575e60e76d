"""The networks a configuration names, found by file name.

A configuration's slots `teacher` and `student` each name a network by
`arch`; `benchmark/networks/<arch>.py` is that network's file, loaded by
path as `harness.load_reader` loads a metric's reader. It gives:
  * `spec(slot, classes)`: the reference's spec of the network the slot
    describes;
  * `forward(ctx, spec, x)`: the reference forward of `nets.Ctx`, returning
    (logits, auxiliary logits or None, the feature Pa compares);
  * `program_fields(slot)`: the program's `TrainConfig` fields for the slot;
  * `served(slot, classes, device)`: the program's module the val sweep
    serves (it imports the program inside the function);
  * optionally `make_state(spec, gen, device)`: the seeded state dict, where
    `weights.make_state`'s convolutions, ABNs and PReLUs do not cover it.
A network file imports at module level nothing but torch and
`benchmark.reference`, so the reference stays free of the program.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict

__all__ = ["NETWORKS_DIR", "network", "spec_of", "forward"]

NETWORKS_DIR = Path(__file__).resolve().parent.parent / "networks"
_loaded: Dict[Path, ModuleType] = {}


def network(arch: str) -> ModuleType:
    """The module of `NETWORKS_DIR/<arch>.py`, loaded once a path."""
    path = NETWORKS_DIR / f"{arch}.py"
    if path not in _loaded:
        if not path.is_file():
            raise KeyError(f"no network file {path} for arch {arch!r}")
        spec = importlib.util.spec_from_file_location(f"benchmark_network_{arch}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        _loaded[path] = module
    return _loaded[path]


def spec_of(slot: dict, classes: int) -> dict:
    """The reference's spec of a configuration's slot, with its `arch`, by
    which `forward` finds the network again."""
    return {**network(slot["arch"]).spec(slot, classes), "arch": slot["arch"]}


def forward(c, spec: dict, x):
    """(logits, auxiliary logits or None, feature) of the spec's network."""
    return network(spec["arch"]).forward(c, spec, x)
