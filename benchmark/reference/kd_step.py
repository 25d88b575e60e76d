"""The reference distillation step (Liu et al., CVPR'19 / TPAMI), plain PyTorch.

One step on a batch, in the recipe's order:
  1. the frozen teacher's forward in eval mode;
  2. the student's forward in train mode; for a student whose grid differs
     from the teacher's (ESPNet-C floors where the PSPNet stem ceils), the
     teacher's logits and feature resized to the student's grid (align
     corners);
  3. G loss = CE(main↑) + 0.4·CE(aux↑), the second term only for a student
     with an auxiliary head (align-corners upsample to the label size, label
     255 ignored, mean over the rest) + λ_pi·Pi + λ_pa·Pa +
     λ_d·(−mean D(S)), where D runs in train mode; the gradient w.r.t. the
     student's parameters only; SGD: d = g + wd·p, buf = m·buf + d,
     p −= lr·buf, with the poly lr base·((num_steps − step)/num_steps)^0.9
     computed in float32;
  4. with Ho: D loss = λ_d·(mean D(S) − mean D(T)) + λ_d·λ_gp·E[(‖∇D(x̂)‖ − 1)²]
     on x̂ = α·T + (1 − α)·S (per-sample α), D's parameters as before the
     step, then D's SGD update. D's spectral u and v advance at each of its
     applications, in the order G-adv, D(T), D(S), GP.
Pi = Σ −softmax(T)·log_softmax(S) / (h·w); Pa = Σ (G_T − G_S)² / (h·w)² / B
over the Gram matrices of channel-normalised features after a ceil-mode max
pool of kernel = stride = ⌊side·0.5⌋.

Each network is the file its configuration slot names (`archs.py`).

Uniforms: each step draws, from one CPU `torch.Generator`, the DSN dropout's
(N, C, 1, 1), the PSP dropout's (N, C, 1, 1), then the GP's α (N, 1, 1, 1),
where the student has dropout and the step a GP; that order is the one the
benchmark hands the program's trainer with the same generator.
"""

from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import archs, nets

__all__ = ["Recipe", "poly_lr", "ref_steps"]


class Recipe:
    """The numbers of a configuration's step (the config file's `recipe`)."""

    def __init__(self, d: dict):
        self.classes = int(d["classes"])
        self.ignore = int(d.get("ignore_label", 255))
        self.pi, self.pa, self.ho = bool(d["pi"]), bool(d["pa"]), bool(d["ho"])
        self.lambda_pi = float(d.get("lambda_pi", 10.0))
        self.lambda_pa = float(d.get("lambda_pa", 1.0))
        self.lambda_d = float(d.get("lambda_d", 0.1))
        self.lambda_gp = float(d.get("lambda_gp", 10.0))
        self.pool_scale = float(d.get("pool_scale", 0.5))
        self.lr_g, self.lr_d = float(d.get("lr_g", 1e-2)), float(d.get("lr_d", 4e-4))
        self.momentum = float(d.get("momentum", 0.9))
        self.wd = float(d.get("weight_decay", 1e-4))
        self.power = float(d.get("power", 0.9))
        self.num_steps = int(d.get("num_steps", 40000))
        self.dsn_weight = 0.4


def poly_lr(base: float, step: int, num_steps: int, power: float) -> float:
    remaining = num_steps - min(int(step), num_steps)
    return float(np.float32(base) * (np.float32(remaining) / np.float32(num_steps))
                 ** np.float32(power))


def _ce(logits, labels, ignore):
    lab = labels.long()
    mask = lab != ignore
    ce = F.cross_entropy(logits, torch.where(mask, lab, torch.zeros_like(lab)),
                         reduction="none")
    return (ce * mask).sum() / mask.sum().clamp_min(1)


def _gram(f):
    n, c, h, w = f.shape
    f = f / (torch.sqrt((f * f).sum(1, keepdim=True)) + 1e-8).detach()
    f = f.reshape(n, c, h * w)
    return torch.bmm(f.transpose(1, 2), f)


def pa_loss(fs, ft, scale):
    h, w = ft.shape[2:]
    k = (int(h * scale), int(w * scale))
    ps, pt = (F.max_pool2d(t, k, k, 0, ceil_mode=True) for t in (fs, ft))
    d = _gram(pt.detach()) - _gram(ps)
    return (d * d).sum() / (pt.shape[2] * pt.shape[3]) ** 2 / pt.shape[0]


def pi_loss(ls, lt):
    h, w = ls.shape[2:]
    return (-F.softmax(lt.detach(), 1) * F.log_softmax(ls, 1)).sum() / (h * w)


def _sgd(params: Dict[str, torch.Tensor], names: List[str], grads, bufs: Dict, lr: float,
         r: Recipe):
    for name, g in zip(names, grads):
        d = g + r.wd * params[name]
        bufs[name] = d if name not in bufs else r.momentum * bufs[name] + d
        params[name] = params[name] - lr * bufs[name]


def ref_steps(specs: dict, state: dict, batches, r: Recipe, prec: Callable,
              draws: Callable, first_step: int, host: bool = True) -> dict:
    """Follow len(batches) steps from `state` = {"teacher", "student",
    "disc": name → f32 tensor, "g_buf", "d_buf": name → momentum buffer (an
    empty dict before the first step)}. `batches` is a list of (images NCHW
    f32, labels NHW). Returns per-step losses (floats; tensors with
    `host=False`, which reads nothing back, as on fake tensors), the
    student's and D's gradients of the first step (name → tensor), the
    student's running variances after it, and the final state."""
    num = float if host else (lambda t: t)
    t = state["teacher"]
    s = {k: v.clone() for k, v in state["student"].items()}
    d = {k: v.clone() for k, v in state["disc"].items()}
    g_buf = {k: v.clone() for k, v in state["g_buf"].items()}
    d_buf = {k: v.clone() for k, v in state["d_buf"].items()}
    s_names = [n for n in s if not n.endswith(("running_mean", "running_var"))]
    d_names = [n for n in d if not n.endswith(("running_mean", "running_var", "weight_u",
                                                  "weight_v"))]
    losses, first, first_stats = [], None, None
    for i, (images, labels) in enumerate(batches):
        step = first_step + i
        with torch.no_grad():
            lt, _, ft = archs.forward(nets.Ctx(t, prec, False), specs["teacher"], images)
        sp = {k: (v.requires_grad_(True) if k in s_names else v)
              for k, v in ((k, v.detach()) for k, v in s.items())}
        cs = nets.Ctx(sp, prec, True, draws)
        ls, aux, fs = archs.forward(cs, specs["student"], images)
        if lt.shape[2:] != ls.shape[2:]:
            lt = nets.up(lt, tuple(ls.shape[2:]))
            ft = nets.up(ft, tuple(fs.shape[2:]))
        size = tuple(labels.shape[1:])
        mc = _ce(nets.up(ls, size), labels, r.ignore)
        if aux is not None:
            mc = mc + r.dsn_weight * _ce(nets.up(aux, size), labels, r.ignore)
        terms = {"mc_loss": mc}
        g_loss = mc
        if r.pi:
            terms["pi_loss"] = pi_loss(ls, lt)
            g_loss = g_loss + r.lambda_pi * terms["pi_loss"]
        if r.pa:
            terms["pa_loss"] = pa_loss(fs, ft, r.pool_scale)
            g_loss = g_loss + r.lambda_pa * terms["pa_loss"]
        cg = nets.Ctx(dict(d), prec, True)
        if r.ho:
            terms["adv_g_loss"] = -nets.disc_forward(cg, specs["disc"], ls).mean()
            g_loss = g_loss + r.lambda_d * terms["adv_g_loss"]
        g_grads = torch.autograd.grad(g_loss, [sp[n] for n in s_names])
        g_scale = (mc.abs() + r.lambda_pi * terms.get("pi_loss", mc * 0).abs()
                   + r.lambda_pa * terms.get("pa_loss", mc * 0).abs()
                   + r.lambda_d * terms.get("adv_g_loss", mc * 0).abs())
        s = {k: v.detach() for k, v in sp.items()}
        _sgd(s, s_names, [g.detach() for g in g_grads], g_buf,
             poly_lr(r.lr_g, step, r.num_steps, r.power), r)
        rec = {"g_loss": num(g_loss.detach()), "g_scale": num(g_scale.detach()),
               **{k: num(v.detach()) for k, v in terms.items()}}
        d_grads = None
        if r.ho:
            d = {k: v.detach() for k, v in cg.p.items()}
            d_loss, d_scale, d_grads, d = _d_step(specs["disc"], d, d_names, lt.detach(),
                                                  ls.detach(), draws, prec, r)
            d_loss, d_scale = num(d_loss), num(d_scale)
            _sgd(d, d_names, d_grads, d_buf, poly_lr(r.lr_d, step, r.num_steps, r.power), r)
            rec.update(d_loss=d_loss, d_scale=d_scale)
        losses.append(rec)
        if i == 0:
            first = {"student": dict(zip(s_names, [g.detach() for g in g_grads])),
                     "disc": {} if d_grads is None else dict(zip(d_names, d_grads))}
            first_stats = {k: v for k, v in s.items() if k.endswith("running_var")}
    return {"losses": losses, "first_grads": first, "first_stats": first_stats,
            "state": {"student": s, "disc": d, "g_buf": g_buf, "d_buf": d_buf}}


def _d_step(spec, d, d_names, lt, ls, draws, prec, r: Recipe):
    """D's loss (wgan-gp) and its gradients w.r.t. D's parameters as they
    were before the step; returns (loss, scale, grads, d with the new u, v
    and running statistics), the first two as 0-dim tensors."""
    dp = {k: (v.detach().requires_grad_(True) if k in d_names else v.detach())
          for k, v in d.items()}
    c = nets.Ctx(dp, prec, True)
    out_t = nets.disc_forward(c, spec, lt)
    out_s = nets.disc_forward(c, spec, ls)
    alpha = draws((ls.shape[0], 1, 1, 1)).to(ls.device)
    interp = (alpha * lt + (1 - alpha) * ls).requires_grad_(True)
    score = nets.disc_forward(c, spec, interp)
    (grad,) = torch.autograd.grad(score.sum(), interp, create_graph=True)
    gp = r.lambda_gp * ((grad.reshape(grad.shape[0], -1).norm(dim=1) - 1.0) ** 2).mean()
    loss = r.lambda_d * (out_s.mean() - out_t.mean()) + r.lambda_d * gp
    grads = torch.autograd.grad(loss, [dp[n] for n in d_names])
    scale = r.lambda_d * (out_s.mean().abs() + out_t.mean().abs() + gp.abs())
    new = {k: v.detach() for k, v in dp.items()}
    return loss.detach(), scale.detach(), [g.detach() for g in grads], new
