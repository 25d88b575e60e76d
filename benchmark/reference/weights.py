"""Seeded weights of the reference's networks, made in a few large calls.

Every state dict is made on `device` from one `torch.Generator` of that
device, seeded from the run's seed, in float32 (the type the models keep
their parameters in):
  * convolutions: He normal over the fan-out (PSPNet, ESPNet-C), LeCun
    normal over the fan-in (the classifier heads, whose logits then have a
    spread of a few units, as a trained network's; the discriminator), one
    `randn` per network;
  * ABN weights in ±[0.5, 1.5] (a quarter negative, so |w| + eps matters),
    biases 0.1·N(0, 1), convolution biases 0.01·N(0, 1), PReLU slopes
    0.25 + 0.05·N(0, 1), attention gammas U[0, 0.5), spectral u and v unit
    vectors;
  * running statistics 0 and 1, until `calibrate` sets them to the batch
    statistics of a train-mode forward over a batch of the run's inputs,
    as a trained network's statistics fit its activations.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark.reference import archs, nets

__all__ = ["make_state", "calibrate"]


def _fill_convs(spec, gen, device, out: Dict[str, torch.Tensor]) -> None:
    convs = spec["convs"]
    sizes = [cout * cin * k * k for _, cout, cin, k, _ in convs]
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    nb = sum(cout for _, cout, _, _, bias in convs if bias)
    bias_flat = 0.01 * torch.randn(max(nb, 1), generator=gen, device=device)
    off = boff = 0
    for (name, cout, cin, k, bias), n in zip(convs, sizes):
        std = (math.sqrt(1.0 / (cin * k * k)) if name in spec["classifiers"]
               else math.sqrt(2.0 / (cout * k * k)))
        out[name + ".weight"] = flat[off:off + n].view(cout, cin, k, k) * std
        off += n
        if bias:
            out[name + ".bias"] = bias_flat[boff:boff + cout].clone()
            boff += cout


def _fill_bns(bns, gen, device, out: Dict[str, torch.Tensor]) -> None:
    total = sum(c for _, c in bns)
    u = torch.rand(3, total, generator=gen, device=device)
    b = 0.1 * torch.randn(total, generator=gen, device=device)
    off = 0
    for name, c in bns:
        sign = torch.where(u[0, off:off + c] < 0.25, -1.0, 1.0)
        out[name + ".weight"] = sign * (0.5 + u[1, off:off + c])
        out[name + ".bias"] = b[off:off + c].clone()
        out[name + ".running_mean"] = torch.zeros(c, device=device)
        out[name + ".running_var"] = torch.ones(c, device=device)
        off += c


def make_state(spec: dict, gen, device) -> Dict[str, torch.Tensor]:
    """A state dict of a spec's network under its torch names (`gen` None:
    torch's default generator, as on fake tensors); the network file's own
    `make_state` where it has one."""
    own = getattr(archs.network(spec["arch"]), "make_state", None) if "arch" in spec else None
    if own is not None:
        return own(spec, gen, device)
    out: Dict[str, torch.Tensor] = {}
    if spec["kind"] == "disc":
        keys = nets.disc_keys(spec)
        lecun = [(n, s) for n, s, kind in keys if kind == "lecun"]
        flat = torch.randn(sum(math.prod(s) for _, s in lecun), generator=gen, device=device)
        off = 0
        for name, shape in lecun:
            n = math.prod(shape)
            out[name] = flat[off:off + n].view(shape) * nets.lecun_scale(shape)
            off += n
        for name, shape, kind in keys:
            if kind == "bias":
                out[name] = 0.01 * torch.randn(shape, generator=gen, device=device)
            elif kind == "bn_weight":
                out[name] = 0.5 + torch.rand(shape, generator=gen, device=device)
            elif kind == "bn_bias":
                out[name] = 0.1 * torch.randn(shape, generator=gen, device=device)
            elif kind == "zeros":
                out[name] = torch.zeros(shape, device=device)
            elif kind == "ones":
                out[name] = torch.ones(shape, device=device)
            elif kind == "unit":
                v = torch.randn(shape, generator=gen, device=device)
                out[name] = v / (torch.linalg.vector_norm(v) + 1e-12)
            elif kind == "gamma":
                out[name] = 0.5 * torch.rand(shape, generator=gen, device=device)
        return {name: out[name] for name, _, _ in keys}
    _fill_convs(spec, gen, device, out)
    _fill_bns(spec["bns"], gen, device, out)
    for name, c in spec.get("prelus", []):
        out[name + ".alpha"] = 0.25 + 0.05 * torch.randn(c, generator=gen, device=device)
    return out


@torch.no_grad()
def calibrate(spec: dict, state: Dict[str, torch.Tensor], images: torch.Tensor) -> None:
    """Set every running statistic of `state` to the batch statistics of a
    train-mode forward over `images` (the dropouts, which feed no ABN, keep
    every channel)."""
    p = dict(state)
    c = nets.Ctx(p, lambda t: t, True, lambda shape: torch.zeros(shape), momentum=1.0)
    archs.forward(c, spec, images.float())
    for k in state:
        if k.endswith(("running_mean", "running_var")):
            state[k] = p[k]
