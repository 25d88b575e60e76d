"""The KD train step: teacher forward, 4-term G loss, D step with WGAN-GP.

Counterpart of `structure_knowledge_distillation_tpu/training/train_step.py`
(reference `NetModel.optimize_parameters`, networks/kd_model.py:119-173), in
the same order and with the same detach points:

  1. the teacher forward in eval mode under `no_grad`;
  2. the student train forward; the G loss is the DSN cross-entropy (the
     upsampled-CE kernels K4/K5 on the card) + λ_pi·Pi + λ_pa·Pa +
     λ_d·AdvG, where AdvG applies D in train mode to the student's logits
     with gradient;
  3. the G gradients are taken with `torch.autograd.grad` w.r.t. the student
     parameters only: D's parameters get no gradient from the G loss, which
     the JAX step also throws away; then G SGD;
  4. D loss = λ_d·adv(D(S), D(T)) (+ λ_d·λ_gp·GP for wgan-gp) on the
     detached teacher and student logits, D's parameters as they were before
     the step; then D SGD.

D's running statistics and spectral u/v advance at each D application, in
order: G-adv, D(T), D(S), GP (4 per step with wgan-gp, 3 with hinge). The
modules are updated in place; `train_step` returns the metrics as detached
0-dim tensors, so it does not wait for the device.

The teacher forward, the G loss-and-update and the D loss-and-update run
under `torch.profiler.record_function` ranges (`teacher_forward`, as the JAX
step's `jax.named_scope`s, `student_loss_and_grad` and `d_loss_and_grad`),
so a profile splits the step the same way.

Randomness: the dropout masks and the GP α come from one `torch.Generator`
(drawn on the CPU); `alpha` may be given instead, as the parity tests do
with the JAX step's α.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
from torch.profiler import record_function

from structure_knowledge_distillation_tpu_torch.losses import (
    adv_loss_for_d,
    adv_loss_for_g,
    criterion_dsn,
    criterion_dsn_fused,
    gp_alpha,
    gradient_penalty,
    pairwise_affinity_loss,
    pixel_wise_kl,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.training.train_state import KDTrainState, set_lr

__all__ = ["make_train_step", "make_train_loop"]

OHEM_ITEM = "the OHEM task loss is ROADMAP Queue A item 7 'VOC/CamVid/ESPNet'"
ESPNET_ITEM = "the ESPNet student is ROADMAP Queue A item 7 'VOC/CamVid/ESPNet'"
LOOP_ITEM = ("multi-step device loops (unroll_steps > 1, CUDA-graph capture) are "
             "ROADMAP Queue A item 6c 'fewer host launches'")

Metrics = Dict[str, torch.Tensor]


def _use_fused_ce(cfg) -> bool:
    """'auto' and 'true': the fused criterion, whose wrappers launch the
    kernels on CUDA tensors and take the plain versions on CPU tensors;
    'false': the materialised `criterion_dsn`."""
    flag = getattr(cfg, "fused_ce", "auto")
    if flag in (False, "false", "False"):
        return False
    if flag in (True, "true", "True", "auto"):
        return True
    raise ValueError(f"fused_ce should be auto, true or false, got {flag!r}")


def make_train_step(cfg) -> Callable:
    """The train step for a TrainConfig: `train_step(state, images, labels,
    generator=None, alpha=None)` takes (N, 3, H, W) float images (f32, or
    bf16 from the narrowed wire) and (N, H, W) integer labels (int32, or
    uint8 from the wire, widened to int32 on the device first, as the JAX
    step does) on the models' device, updates `state` in place and returns
    its metrics."""
    if getattr(cfg, "ohem", False):
        raise NotImplementedError(OHEM_ITEM)
    if getattr(cfg, "student_arch", "resnet18") != "resnet18":
        raise NotImplementedError(ESPNET_ITEM)
    if int(getattr(cfg, "unroll_steps", 1)) > 1:
        raise NotImplementedError(LOOP_ITEM)
    fused = _use_fused_ce(cfg)

    def g_loss_fn(student, disc, images, labels, logits_t, feat_t, generator):
        preds_s = student(images, generator)
        # cross-family pairs (a floor-stride student under a ceil-stride
        # teacher) align the teacher's grid to the student's; a no-op for
        # the reference R101 → R18 pair
        if logits_t.shape[2:] != preds_s[0].shape[2:]:
            logits_t = resize_bilinear_align_corners(logits_t, tuple(preds_s[0].shape[2:]))
            feat_t = resize_bilinear_align_corners(feat_t, tuple(preds_s[2].shape[2:]))
        if fused:
            mc = criterion_dsn_fused(preds_s, labels, cfg.ignore_label)
        else:
            mc = criterion_dsn(preds_s, labels, cfg.ignore_label)
        loss = mc
        metrics = {"mc_loss": mc}
        if cfg.pi:
            pi_l = pixel_wise_kl(preds_s[0], logits_t)
            metrics["pi_loss"] = pi_l
            loss = loss + cfg.lambda_pi * pi_l
        if cfg.pa:
            pa_l = pairwise_affinity_loss(preds_s[2], feat_t, cfg.pool_scale)
            metrics["pa_loss"] = pa_l
            loss = loss + cfg.lambda_pa * pa_l
        if cfg.ho:
            adv_g = adv_loss_for_g(disc(preds_s[0])[0], cfg.adv_loss_type)
            metrics["adv_g_loss"] = adv_g
            loss = loss + cfg.lambda_d * adv_g
        metrics["g_loss"] = loss
        return loss, metrics, preds_s[0].detach(), logits_t

    def d_loss_fn(disc, logits_t, logits_s, generator, alpha):
        out_t = disc(logits_t)[0]
        out_s = disc(logits_s)[0]
        d_loss = cfg.lambda_d * adv_loss_for_d(out_s, out_t, cfg.adv_loss_type)
        if cfg.adv_loss_type == "wgan-gp":
            if alpha is None:
                alpha = gp_alpha(logits_t.shape[0], logits_t.device, generator)
            gp = gradient_penalty(lambda x: disc(x)[0], logits_t, logits_s, alpha,
                                  cfg.lambda_gp)
            d_loss = d_loss + cfg.lambda_d * gp
        return d_loss

    def sgd_step(module, loss, opt, lr):
        params = [p for p in module.parameters() if p.requires_grad]
        for p, g in zip(params, torch.autograd.grad(loss, params)):
            p.grad = g
        set_lr(opt, lr)
        opt.step()

    def train_step(state: KDTrainState, images: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   alpha: Optional[torch.Tensor] = None) -> Metrics:
        labels = labels.to(torch.int32)
        teacher, student, disc = state.teacher, state.student, state.discriminator
        teacher.eval()
        student.train()
        disc.train()

        with torch.no_grad(), record_function("teacher_forward"):
            preds_t = teacher(images)

        # --- G (student) loss and update; the gradient reaches the student
        # parameters only
        with record_function("student_loss_and_grad"):
            g_loss, metrics, logits_s, logits_t = g_loss_fn(
                student, disc, images, labels, preds_t[0], preds_t[2], generator)
            sgd_step(student, g_loss, state.g_opt, state.g_sched(state.step))

        # --- D loss and update (reference discriminator_backward)
        if cfg.ho:
            with record_function("d_loss_and_grad"):
                d_loss = d_loss_fn(disc, logits_t, logits_s, generator, alpha)
                sgd_step(disc, d_loss, state.d_opt, state.d_sched(state.step))
            metrics["d_loss"] = d_loss
        else:
            metrics["d_loss"] = torch.zeros((), device=images.device)

        state.step += 1
        return {k: v.detach() for k, v in metrics.items()}

    return train_step


def make_train_loop(*args, **kwargs):
    raise NotImplementedError(LOOP_ITEM)
