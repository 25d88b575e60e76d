"""Weights across the two packages, the reference's `.pth` files, and the
trainer's checkpoints.

Counterpart of `structure_knowledge_distillation_tpu/training/checkpoint.py`,
in torch formats. The port's `ResPSPNet` already uses the reference's
state-dict names, so:
  * `state_dict_from_jax` turns the JAX package's variable tree into that
    state dict (what its `export_torch_respspnet` returns, without flax),
    and a folded tree (`fold_bn_variables`'s `{"params"}`) into the state
    dict of `ResPSPNet(fold_bn=True)`;
  * `espnet_state_dict_from_jax` does the same for the ESPNet-C student,
    whose port keeps the flax module names (no reference names exist);
  * `discriminator_state_dict_from_jax` does the same for the SAGAN
    discriminator's `{"params", "batch_stats", "spectral"}` tree (what its
    `export_torch_discriminator` returns);
  * `load_reference_state_dict` merges a torch state dict into a model with
    the JAX importer's semantics: `module.` stripped, the released teachers'
    `head.0.*`/`head.1.*` remapped, `fc.*` and `num_batches_tracked` dropped,
    and every other key taken only where the model has it at the same shape;
  * `load_torch_checkpoint` splits a `.pth[.tar]` into (state dict, meta), as
    the JAX function of that name does;
  * the trainer's files: `save_student_snapshot` (the reference's cadence
    snapshot, a bare student state dict, with a `.json` sidecar of the JAX
    package's meta keys), `save_torch` (atomic) and the auto-resume stream
    `save_auto_resume` / `latest_auto_resume` (the counterpart of the JAX
    package's Orbax directory: full-state files, the newest 3 kept).

Every save is synchronous: written to a temporary name, then renamed. The
port reads and writes torch files only; a JAX `.msgpack` raises `ValueError`
(cross over with the JAX `export_torch_respspnet` and `torch.save`).
Every load keeps `weights_only=True`.
"""

from __future__ import annotations

import json
import logging
import os
import re
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

__all__ = ["state_dict_from_jax", "espnet_state_dict_from_jax",
           "discriminator_state_dict_from_jax",
           "load_torch_state_dict", "load_torch_checkpoint", "load_reference_state_dict",
           "load_meta", "save_torch", "save_student_snapshot", "save_auto_resume",
           "latest_auto_resume"]

log = logging.getLogger(__name__)

_LEAF = {"kernel": "weight", "weight": "weight", "bias": "bias",
         "mean": "running_mean", "var": "running_var"}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], object]:
    out = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _torch_module(mod: Tuple[str, ...]) -> Optional[str]:
    """JAX module path -> the reference's torch module name (None: no counterpart)."""
    if len(mod) == 1 and mod[0].startswith(("conv", "bn")) and "_" not in mod[0]:
        return mod[0]
    if mod == ("head",):
        return "head"
    if mod and mod[0].startswith("layer") and "_" in mod[0]:
        layer, idx = mod[0].split("_")
        sub = {"downsample_conv": "downsample.0", "downsample_bn": "downsample.1"}
        return f"{layer}.{idx}.{sub.get(mod[1], mod[1])}"
    if mod and mod[0] == "pspmodule":
        sub = mod[1]
        if sub.startswith("stage"):
            i = sub[len("stage"):sub.index("_")]
            return f"pspmodule.stages.{i}." + ("1" if sub.endswith("conv") else "2")
        return {"bottleneck_conv": "pspmodule.bottleneck.0",
                "bottleneck_bn": "pspmodule.bottleneck.1"}.get(sub)
    return {("dsn_conv1",): "dsn.0", ("dsn_bn",): "dsn.1",
            ("dsn_conv2",): "dsn.3"}.get(tuple(mod[:1]))


def state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's ResPSPNet `{"params", "batch_stats"}` tree (nested
    dicts of arrays) as the reference's torch state dict of numpy arrays:
    HWIO kernels become OIHW, `mean`/`var` become `running_mean`/`running_var`.
    A folded tree (the JAX `fold_bn_variables`: `{"params"}` alone, a bias on
    every conv that had an ABN) maps by the same names to the state dict of
    `ResPSPNet(fold_bn=True)`, which loads it strictly."""
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})).items():
            torch_mod = _torch_module(path[:-1])
            if torch_mod is None or path[-1] not in _LEAF:
                continue
            v = np.asarray(value)
            if path[-1] == "kernel" and v.ndim == 4:
                v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
            out[f"{torch_mod}.{_LEAF[path[-1]]}"] = v
    return out


_ESPNET_LEAF = {"kernel": "weight", "bias": "bias", "weight": "weight", "alpha": "alpha",
                "mean": "running_mean", "var": "running_var"}


def espnet_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's ESPNetC `{"params", "batch_stats"}` tree as the
    port's `ESPNetC` state dict of numpy arrays: the flax module path joined
    by dots (`level2_down/spp_0/kernel` → `level2_down.spp_0.weight`), HWIO
    kernels as OIHW, each ABN's `weight`/`bias`/`mean`/`var` as `weight`,
    `bias`, `running_mean`, `running_var`, each PReLU's `alpha`, the
    classifiers' `kernel` and `bias`. `ESPNetC.load_state_dict(strict=True)`
    takes the result."""
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats"):
        for path, value in _flatten(variables.get(coll, {})).items():
            v = np.asarray(value)
            if path[-1] == "kernel":
                v = np.transpose(v, (3, 2, 0, 1))  # HWIO -> OIHW
            out[".".join(path[:-1] + (_ESPNET_LEAF[path[-1]],))] = v
    return out


def discriminator_state_dict_from_jax(variables: Mapping) -> Dict[str, np.ndarray]:
    """The JAX package's Discriminator variables as the reference's torch
    state dict of numpy arrays: the preprocess BN under
    `preprocess_additional`, each SN conv under `l{i}.0.module` (HWIO weight
    → OIHW `weight_bar`, spectral u/v → `weight_u`/`weight_v`), the
    attention convs OIHW, and the final conv under `last.0`."""
    bn_leaf = {"weight": "weight", "bias": "bias", "mean": "running_mean", "var": "running_var"}
    oihw = lambda v: np.transpose(v, (3, 2, 0, 1))  # noqa: E731  HWIO -> OIHW
    out: Dict[str, np.ndarray] = {}
    for coll in ("params", "batch_stats", "spectral"):
        for path, value in _flatten(variables.get(coll, {})).items():
            v = np.asarray(value)
            mod, leaf = path[:-1], path[-1]
            if mod == ("preprocess_bn",):
                out[f"preprocess_additional.{bn_leaf[leaf]}"] = v
            elif mod and mod[0] in ("l1", "l2", "l3", "l4"):
                if coll == "spectral":
                    out[f"{mod[0]}.0.module.weight_{leaf}"] = v
                elif leaf == "weight":
                    out[f"{mod[0]}.0.module.weight_bar"] = oihw(v)
                else:
                    out[f"{mod[0]}.0.module.bias"] = v
            elif mod == ("last",):
                out["last.0.weight" if leaf == "kernel" else "last.0.bias"] = (
                    oihw(v) if leaf == "kernel" else v)
            elif mod and mod[0] in ("attn1", "attn2"):
                if leaf == "gamma":
                    out[f"{mod[0]}.gamma"] = v
                elif leaf == "kernel":
                    out[f"{mod[0]}.{mod[1]}.weight"] = oihw(v)
                else:
                    out[f"{mod[0]}.{mod[1]}.bias"] = v
    return out


def _numpy_safe_globals() -> list:
    """The numpy globals that the reference's rich checkpoints pickle beside
    the state dict (`best_mean_IU` a numpy scalar, `IU_array` an ndarray):
    the scalar and ndarray reconstructors under their numpy 1 (`numpy.core`)
    and numpy 2 (`numpy._core`) names, `np.dtype`, its per-type classes, and
    `np.ndarray`. Nothing else of numpy is allowed."""
    multiarray = (np._core if hasattr(np, "_core") else np.core).multiarray
    out = [np.dtype, np.ndarray]
    for core in ("numpy.core", "numpy._core"):
        out += [(multiarray.scalar, f"{core}.multiarray.scalar"),
                (multiarray._reconstruct, f"{core}.multiarray._reconstruct")]
    dtypes = getattr(np, "dtypes", None)  # numpy >= 1.25
    if dtypes is not None:
        out += [getattr(dtypes, n) for n in dir(dtypes) if n.endswith("DType")]
    return out


def _torch_load(path: str):
    if str(path).endswith(".msgpack"):
        raise ValueError(f"{path}: the port reads torch checkpoints (.pth, .pth.tar) only; "
                         "convert a JAX .msgpack with export_torch_respspnet and torch.save")
    with torch.serialization.safe_globals(_numpy_safe_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def load_torch_checkpoint(path: str) -> Tuple[Dict[str, torch.Tensor], dict]:
    """Load a `.pth[.tar]` onto the CPU as (state dict, meta): a rich
    checkpoint's `state_dict` and its other entries (the reference's step /
    best_mean_IU / IU_array, the port's full train state), or a bare state
    dict and {}. Only tensors, plain containers and the numpy scalars and
    arrays of a rich checkpoint's metadata are unpickled; any other object
    is refused."""
    obj = _torch_load(path)
    meta: dict = {}
    if isinstance(obj, dict) and "state_dict" in obj:
        meta = {k: v for k, v in obj.items() if k != "state_dict"}
        obj = obj["state_dict"]
    return {k: v.detach() for k, v in obj.items() if isinstance(v, torch.Tensor)}, meta


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """The state dict of a `.pth` (a bare one, or a `{"state_dict": ...}`
    checkpoint's), on the CPU."""
    return load_torch_checkpoint(path)[0]


def _json_meta(meta: Mapping) -> dict:
    """The JAX package's sidecar values: numbers as floats."""
    return {k: float(v) if isinstance(v, (int, float, np.floating)) else v
            for k, v in meta.items()}


def load_meta(path: str) -> dict:
    """The `.json` sidecar of a snapshot written by `save_student_snapshot`."""
    with open(os.path.splitext(path)[0] + ".json") as f:
        return json.load(f)


def save_torch(obj, path: str) -> str:
    """`torch.save` to a temporary name in the same directory, then rename:
    a reader never sees a half-written file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        torch.save(obj, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


def save_student_snapshot(path: str, student_state: Mapping, **meta) -> str:
    """The reference's cadence snapshot (kd_model.py:192-193): the student's
    state dict alone at `path + ".pth"`, and the meta (the JAX
    `save_student_state` keys: step, mean_iu, state_step) at `path + ".json"`."""
    save_torch(dict(student_state), path + ".pth")
    with open(path + ".json", "w") as f:
        json.dump(_json_meta(meta), f)
    return path + ".pth"


_AUTO_RESUME = re.compile(r"step_(\d+)\.pth$")
AUTO_RESUME_KEEP = 3  # the JAX package's Orbax max_to_keep


def _auto_resume_steps(directory: str) -> Dict[int, str]:
    if not os.path.isdir(directory):
        return {}
    found = (_AUTO_RESUME.fullmatch(name) for name in os.listdir(directory))
    return {int(m.group(1)): os.path.join(directory, m.group(0)) for m in found if m}


def save_auto_resume(directory: str, state: Mapping, step: int) -> str:
    """Write `state` as `<directory>/step_<step>.pth` and keep the newest
    `AUTO_RESUME_KEEP` files. Idempotent per step: a preemption save at the
    step of an eval save finds the file there and writes nothing (the state
    at one step is one state)."""
    path = os.path.join(directory, f"step_{int(step):08d}.pth")
    if not os.path.isfile(path):
        save_torch(dict(state), path)
    steps = _auto_resume_steps(directory)
    for old in sorted(steps)[:-AUTO_RESUME_KEEP]:
        os.unlink(steps[old])
    return path


def latest_auto_resume(directory: str) -> Optional[str]:
    """The newest file of the auto-resume stream, or None."""
    steps = _auto_resume_steps(directory)
    return steps[max(steps)] if steps else None


def _reference_key(key: str) -> Optional[str]:
    """Normalise a reference checkpoint key; None for keys with no counterpart."""
    if key.startswith("module."):
        key = key[len("module."):]
    # released teachers wrap PSP + classifier as `head` (reference utils/utils.py:78-87)
    if key.startswith("head.0."):
        key = "pspmodule." + key[len("head.0."):]
    elif key.startswith("head.1."):
        key = "head." + key[len("head.1."):]
    parts = key.split(".")
    if parts[0] == "fc" or parts[-1] == "num_batches_tracked":
        return None
    return key


def load_reference_state_dict(model: torch.nn.Module,
                              state_dict: Mapping[str, object]) -> list:
    """Merge a reference-style state dict into `model` by intersection with a
    shape check (reference utils/utils.py:101). Returns the skipped keys,
    which are also logged."""
    target = model.state_dict()
    merged, skipped = {}, []
    for key, value in state_dict.items():
        k = _reference_key(key)
        if k is None or k not in target:
            skipped.append(key)
            continue
        v = torch.as_tensor(np.asarray(value) if not isinstance(value, torch.Tensor) else value)
        if tuple(v.shape) != tuple(target[k].shape):
            skipped.append(f"{key} (shape {tuple(v.shape)} vs {tuple(target[k].shape)})")
            continue
        merged[k] = v
    model.load_state_dict(merged, strict=False)
    if skipped:
        log.info("torch import: %d loaded, %d skipped (%s%s)", len(merged), len(skipped),
                 ", ".join(skipped[:5]), "…" if len(skipped) > 5 else "")
    return skipped
