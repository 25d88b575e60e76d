"""Where a train-mode backward on the card stops being reproducible.

Run on a CUDA host from the repository root (imports only the port):

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python tests/card_determinism_probe.py

1. `torch.use_deterministic_algorithms(True)` over the card test
   `test_remat_relaunches_k6_and_equals_plain_on_the_card`'s model (fused
   ABN, remat, f32) and over one Pi+Pa+Ho wgan-gp step of the card tests'
   small models: torch raises at the first op that has no deterministic
   CUDA implementation, and the line names it.
2. That test's two students, plain and rematerialised, each run twice in one
   process with TF32 off and cuDNN deterministic: the gradient at every
   module's output is compared between runs, and the first module (in
   backward order) whose output gradient differs is printed with the
   largest difference, with the parameters whose gradients differ. Run it
   several times: the atomics' order changes from process to process.
"""

from __future__ import annotations

import torch

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step

DEVICE = torch.device("cuda", 0)


def remat_model_backward(remat: bool = True, hooks: bool = False):
    """The card test's student: forward and backward of (2, 3, 96, 96) randn
    (seed 0); with `hooks`, the gradient at every module output (its first
    call, in backward order) and every parameter's gradient."""
    x = torch.randn(2, 3, 96, 96, generator=torch.Generator().manual_seed(0)).to(DEVICE)
    model = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, bn_fused=True,
                      remat=remat, generator=torch.Generator().manual_seed(4)).to(DEVICE).train()
    grads, order = {}, []
    if hooks:
        for name, mod in model.named_modules():
            def hook(mod, inp, out, name=name):
                if name in grads or not isinstance(out, torch.Tensor) or not out.requires_grad:
                    return
                grads[name] = None

                def keep(g, name=name):
                    grads[name] = g.detach().clone()
                    order.append(name)
                out.register_hook(keep)
            if name:
                mod.register_forward_hook(hook)
    outs = model(x)
    (outs[0].float().square().sum() + outs[1].float().sum()).backward()
    torch.cuda.synchronize()
    return grads, order, {k: p.grad.clone() for k, p in model.named_parameters()}


def kd_step():
    cfg = TrainConfig(classes_num=7, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                      adv_conv_dim=16, num_steps=40, compute_dtype="float32", device="cuda")
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), 7, width_mult=0.25, generator=g)
    student = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, generator=g)
    disc = Discriminator(7, 1, 33, 16, generator=g)
    teacher.to(DEVICE).requires_grad_(False)
    state = KDTrainState(
        teacher=teacher, student=student.to(DEVICE), discriminator=disc.to(DEVICE),
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    images = torch.randn(2, 3, 256, 256, generator=torch.Generator().manual_seed(1)).to(DEVICE)
    labels = torch.randint(0, 7, (2, 256, 256), generator=torch.Generator().manual_seed(2))
    make_train_step(cfg)(state, images, labels.to(DEVICE), torch.Generator().manual_seed(3))
    torch.cuda.synchronize()


def deterministic_algorithms() -> None:
    torch.use_deterministic_algorithms(True)
    try:
        for label, fn in (("remat test model fwd+bwd", remat_model_backward),
                          ("KD step (Pi+Pa+Ho, wgan-gp, f32)", kd_step)):
            try:
                fn()
                print(label, "OK: no op without a deterministic implementation")
            except RuntimeError as e:
                print(label, "RAISES:", str(e).split("\n")[0][:300])
    finally:
        torch.use_deterministic_algorithms(False)


def localise() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    runs = {name: remat_model_backward(remat, hooks=True)
            for name, remat in (("plain1", False), ("plain2", False), ("remat1", True),
                                ("remat2", True))}
    for a, b in (("plain1", "plain2"), ("remat1", "remat2"), ("plain1", "remat1"),
                 ("plain2", "remat2")):
        (ga, order, pa), (gb, _, pb) = runs[a], runs[b]
        # module outputs of both models (remat runs a stage's blocks one by
        # one, so its `layerN` Sequentials are never called as modules)
        first = next(((n, float((ga[n] - gb[n]).abs().max())) for n in order
                      if n in gb and not torch.equal(ga[n], gb[n])), None)
        differ = [k for k in pa if not torch.equal(pa[k], pb[k])]
        print(f"{a} vs {b}: first output gradient that differs {first}; "
              f"{len(differ)} parameter gradients differ {differ[:4]}")


if __name__ == "__main__":
    print(torch.cuda.get_device_name(0), torch.__version__, torch.backends.cudnn.version())
    deterministic_algorithms()
    localise()
