"""Holistic (Ho) adversarial losses: G term, D term, WGAN gradient penalty.

Counterpart of `structure_knowledge_distillation_tpu/losses/adversarial.py`
(reference utils/criterion.py:92-166), in f32:
  * G loss: −E[D(S)] for both 'wgan-gp' and 'hinge';
  * D loss: wgan-gp E[D(S)] − E[D(T)]; hinge E[relu(1 − D(T))] + E[relu(1 + D(S))];
  * gradient penalty: λ_gp·E[(‖∇_x D(x̂)‖₂ − 1)²] on the per-sample
    α-interpolation x̂ = α·real + (1 − α)·fake, through
    `torch.autograd.grad(create_graph=True)`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

__all__ = ["adv_loss_for_g", "adv_loss_for_d", "gradient_penalty", "gp_alpha"]

ADV_TYPES = ("wgan-gp", "hinge")


def adv_loss_for_g(d_out_fake: torch.Tensor, adv_type: str = "wgan-gp") -> torch.Tensor:
    if adv_type not in ADV_TYPES:
        raise ValueError("adv_type should be wgan-gp or hinge")
    return -d_out_fake.float().mean()


def adv_loss_for_d(d_out_fake: torch.Tensor, d_out_real: torch.Tensor,
                   adv_type: str = "wgan-gp") -> torch.Tensor:
    fake, real = d_out_fake.float(), d_out_real.float()
    if adv_type == "wgan-gp":
        return fake.mean() - real.mean()
    if adv_type == "hinge":
        return F.relu(1.0 - real).mean() + F.relu(1.0 + fake).mean()
    raise ValueError("adv_type should be wgan-gp or hinge")


def gp_alpha(n: int, device, draws: Callable[[tuple], torch.Tensor]) -> torch.Tensor:
    """One uniform α per sample, (n, 1, 1, 1) f32, from the train step's
    uniform source `draws` (a callable shape -> tensor, as `Dropout2d`
    takes), on `device`."""
    return draws((n, 1, 1, 1)).to(device)


def gradient_penalty(d_score_fn: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, alpha: torch.Tensor,
                     lambda_gp: float = 10.0) -> torch.Tensor:
    """WGAN-GP on α-interpolated inputs; d_score_fn maps a batch to scores
    with a leading N. Differentiating sum(D(x̂)) matches the reference's
    grad_outputs=ones, including the coupling across samples through D's
    train-mode preprocess batch norm."""
    n = real.shape[0]
    interp = alpha * real.detach().float() + (1.0 - alpha) * fake.detach().float()
    interp.requires_grad_(True)
    (grad,) = torch.autograd.grad(d_score_fn(interp).float().sum(), interp, create_graph=True)
    grad_norm = torch.sqrt((grad.reshape(n, -1) ** 2).sum(dim=1))
    return lambda_gp * ((grad_norm - 1.0) ** 2).mean()
