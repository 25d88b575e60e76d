"""The benchmark's one generator of inputs: images and labels from a seed.

Images are mean-subtracted BGR frames, as the loaders hand them to the
program: a smooth field (random values on a grid of one cell per 32 pixels,
upsampled bilinearly) of standard deviation `field_std`, a per-frame,
per-channel offset of `offset_std`, and per-pixel noise of `noise_std`. So
frames differ in their global statistics, as photographs do, and a pyramid
pool's coarse bins see different values in different frames. Labels are
regions: the argmax over classes of a smooth random field on a grid of one
cell per `label_cell` pixels, upsampled, with a share `ignore_frac` of the
pixels set to the ignore label.

Everything is drawn on `device` from one `torch.Generator` of that device,
so the same seed gives the same inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["make_generator", "images", "labels"]


def make_generator(device, seed: int, stream: int) -> torch.Generator:
    """A generator of `device` for one stream of a run's draws; streams of
    one seed never share a state."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream * 7919) % (2 ** 63 - 1))
    return g


def images(gen: torch.Generator, n: int, size, traffic: dict, device) -> torch.Tensor:
    """(n, 3, H, W) float32 frames."""
    h, w = size
    cell = int(traffic.get("image_cell", 32))
    coarse = torch.randn(n, 3, -(-h // cell) + 1, -(-w // cell) + 1, generator=gen,
                         device=device)
    field = F.interpolate(coarse, size=(h, w), mode="bilinear", align_corners=True)
    offset = torch.randn(n, 3, 1, 1, generator=gen, device=device)
    noise = torch.randn(n, 3, h, w, generator=gen, device=device)
    return (float(traffic.get("field_std", 50.0)) * field
            + float(traffic.get("offset_std", 20.0)) * offset
            + float(traffic.get("noise_std", 20.0)) * noise)


def labels(gen: torch.Generator, n: int, size, classes: int, traffic: dict, device,
           ignore: int = 255) -> torch.Tensor:
    """(n, H, W) uint8 class maps with ignored pixels."""
    h, w = size
    cell = int(traffic.get("label_cell", 64))
    coarse = torch.randn(n, classes, -(-h // cell) + 1, -(-w // cell) + 1, generator=gen,
                         device=device)
    lab = F.interpolate(coarse, size=(h, w), mode="bilinear",
                        align_corners=True).argmax(1).to(torch.uint8)
    drop = torch.rand(n, h, w, generator=gen, device=device) < float(
        traffic.get("ignore_frac", 0.05))
    return torch.where(drop, torch.full_like(lab, ignore), lab)
