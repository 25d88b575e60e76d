"""Eval-mode ABN folding: a ResPSPNet state dict -> the `fold_bn=True` one.

Counterpart of `structure_knowledge_distillation_tpu/models/fold.py`. In
eval mode every ABN is a fixed per-channel affine map after its conv,

    y = (conv(x) + b − mean) · g / sqrt(var + eps) + beta,   g = |weight| + eps

so `fold_bn_state_dict` multiplies `g / sqrt(var + eps)` into the conv's
output channels (dim 0 of an OIHW weight) and makes the rest the conv's bias,
in float64, then casts back to the weight's dtype. `ResPSPNet(fold_bn=True)`,
whose ABNs are their bare activations, loads the result strictly: one
elementwise pass less per conv at inference (≈ 100 in an R101 forward).

The pairs come from the port's module tree, which is the reference's: an ABN
is registered right after the conv it normalises, in the same parent, as
`<parent>.bnN` after `<parent>.convN` (the stem and the residual blocks) or
as `<parent>.<k>` after `<parent>.<k−1>` in an `nn.Sequential` (`downsample`,
the PSP stages and bottleneck, the DSN head). `head` and `dsn.3` have no ABN
and pass through unchanged; `dsn.0` has a bias, which is folded through.
"""

from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

__all__ = ["abn_conv_pairs", "fold_bn_state_dict"]

_ABN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _conv_of(abn: str) -> str:
    """The module that an ABN at `abn` follows: `P.bnN` -> `P.convN`,
    `P.k` -> `P.(k-1)`."""
    parent, _, name = abn.rpartition(".")
    prefix = parent + "." if parent else ""
    if name.startswith("bn") and name[2:].isdigit():
        return prefix + "conv" + name[2:]
    if name.isdigit() and int(name) > 0:
        return prefix + str(int(name) - 1)
    raise KeyError(f"{abn}: not an ABN slot of the ResPSPNet module tree")


def abn_conv_pairs(state_dict: Mapping[str, object]) -> Dict[str, str]:
    """{ABN module: conv module} of a ResPSPNet state dict. An ABN is a
    module with a `running_mean` entry; its conv must have a 4-D weight with
    one output channel per ABN channel (else KeyError or ValueError)."""
    pairs = {}
    for key in state_dict:
        if not key.endswith(".running_mean"):
            continue
        abn = key[: -len(".running_mean")]
        conv = _conv_of(abn)
        w = state_dict.get(conv + ".weight")
        if w is None or len(w.shape) != 4:
            raise KeyError(f"{abn}: no conv weight at {conv}.weight")
        if w.shape[0] != state_dict[key].shape[0]:
            raise ValueError(f"{abn} has {state_dict[key].shape[0]} channels, "
                             f"{conv} {w.shape[0]} outputs")
        pairs[abn] = conv
    return pairs


def _tensor(v) -> torch.Tensor:
    return v.detach() if isinstance(v, torch.Tensor) else torch.from_numpy(np.asarray(v))


def _f64(v) -> torch.Tensor:
    return _tensor(v).to("cpu", torch.float64)


def fold_bn_state_dict(state_dict: Mapping[str, object], eps: float = 1e-5,
                       abs_gamma: bool = True) -> Dict[str, torch.Tensor]:
    """An unfolded ResPSPNet state dict (the port's, which are the reference's
    names; torch tensors or numpy arrays) -> the folded one for
    `ResPSPNet(fold_bn=True)`, as tensors. Each ABN's entries go; its conv's
    weight is scaled per output channel and the conv gains (or updates) its
    bias, written right after the weight, both in the weight's dtype and on
    its device (the arithmetic runs in float64 on the CPU). The gamma
    convention is the reference's (|weight| + eps, libs/src/bn.cu:153)
    unless `abs_gamma` is False. Every other entry passes through."""
    pairs = abn_conv_pairs(state_dict)
    folded = {}  # conv module -> (weight, bias)
    for abn, conv in pairs.items():
        gamma = _f64(state_dict[abn + ".weight"])
        beta = _f64(state_dict[abn + ".bias"])
        mean = _f64(state_dict[abn + ".running_mean"])
        var = _f64(state_dict[abn + ".running_var"])
        g = gamma.abs() + eps if abs_gamma else gamma
        scale = g / torch.sqrt(var + eps)
        w = _tensor(state_dict[conv + ".weight"])
        weight = _f64(w) * scale.view(-1, 1, 1, 1)  # OIHW: out channel first
        bias = beta - mean * scale
        old_bias = state_dict.get(conv + ".bias")
        if old_bias is not None:
            bias = bias + _f64(old_bias) * scale
        folded[conv] = (weight.to(w.device, w.dtype), bias.to(w.device, w.dtype))

    drop = {f"{abn}.{leaf}" for abn in pairs for leaf in _ABN_LEAVES}
    out: Dict[str, torch.Tensor] = {}
    for key, value in state_dict.items():
        if key in drop:
            continue
        module, _, leaf = key.rpartition(".")
        if module in folded:
            if leaf == "weight":
                out[key], out[module + ".bias"] = folded[module]
            continue  # the old bias is folded into the new one
        out[key] = _tensor(value)
    return out
