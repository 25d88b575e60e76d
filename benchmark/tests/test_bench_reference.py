"""The benchmark's plain reference against the program at toy sizes on the
CPU, float32: the same state dicts and draws on both sides."""

from __future__ import annotations

import pytest
import torch

from benchmark import inputs
from benchmark.reference import archs, kd_step, nets, precision, weights

C = 5


def _state(spec, seed=3):
    return weights.make_state(spec, torch.Generator().manual_seed(seed), "cpu")


def _images(n, size, seed=1):
    return inputs.images(inputs.make_generator("cpu", seed, 0), n, size, {}, "cpu")


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def test_state_dicts_have_the_program_keys():
    from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ESPNetC
    from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
    from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator

    cases = [(nets.psp_spec("bottleneck", (3, 4, 23, 3), 19), ResPSPNet(BOTTLENECK)),
             (nets.psp_spec("basic", (2, 2, 2, 2), 19), ResPSPNet(BASIC, (2, 2, 2, 2))),
             (nets.espnet_spec(11), ESPNetC(11)),
             (nets.disc_spec(19, 65, 64), Discriminator(19, image_size=65)),
             (nets.disc_spec(11, 46, 64), Discriminator(11, image_size=46))]
    for spec, model in cases:
        with torch.device("meta"):
            ours = weights.make_state(spec, None, "meta")
        theirs = model.state_dict()
        assert set(ours) == set(theirs)
        assert all(tuple(ours[k].shape) == tuple(theirs[k].shape) for k in ours)


def test_pspnet_forwards_match():
    from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ResPSPNet
    from structure_knowledge_distillation_tpu_torch.training.checkpoint import (
        load_reference_state_dict,
    )

    x = _images(4, (96, 128))
    for arch, block, layers in (("pspnet", BOTTLENECK, (1, 1, 1, 1)),
                                ("resnet18", BASIC, (2, 2, 2, 2))):
        spec = archs.spec_of({"arch": arch, "block": block, "layers": layers}, C)
        st = _state(spec)
        weights.calibrate(spec, st, x)
        model = ResPSPNet(block, layers, C)
        load_reference_state_dict(model, st)
        with torch.no_grad():
            model.eval()
            ref = nets.psp_forward(nets.Ctx(dict(st), precision.Exact(), False), spec, x)
            got = model(x)
            for i in range(3):
                assert _rel(got[i], ref[i]) < 1e-4
            model.train()
            g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
            got = model(x, lambda s: torch.rand(s, generator=g1))
            ref = nets.psp_forward(nets.Ctx(dict(st), precision.Exact(), True,
                                            lambda s: torch.rand(s, generator=g2)), spec, x)
            for i in range(3):
                assert _rel(got[i], ref[i]) < 1e-4


def test_espnet_and_discriminator_forwards_match():
    from structure_knowledge_distillation_tpu_torch.models import ESPNetC
    from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator
    from structure_knowledge_distillation_tpu_torch.training.checkpoint import (
        load_reference_state_dict,
    )

    x = _images(4, (64, 96))
    spec = nets.espnet_spec(C)
    st = _state(spec)
    model = ESPNetC(C)
    load_reference_state_dict(model, st)
    model.train()
    with torch.no_grad():
        got = model(x)
        ref = nets.espnet_forward(nets.Ctx(dict(st), precision.Exact(), True), spec, x)
    for a, b in zip((got[0], got[1], got[2]), ref):
        assert _rel(a, b) < 1e-4
    dspec = nets.disc_spec(C, 33, 16)
    dst = _state(dspec, 7)
    disc = Discriminator(C, image_size=33, conv_dim=16)
    disc.load_state_dict(dst)
    disc.train()
    s = torch.randn(4, C, 33, 33, generator=torch.Generator().manual_seed(2))
    with torch.no_grad():
        got = disc(s)[0].reshape(-1)
    p = dict(dst)
    ref = nets.disc_forward(nets.Ctx(p, precision.Exact(), True), dspec, s)
    assert _rel(got, ref) < 1e-4
    assert _rel(disc.l1[0].module.weight_u, p["l1.0.module.weight_u"]) < 1e-5


@pytest.mark.parametrize("ho", [True, False])
def test_first_step_matches_the_program_step(ho):
    """One train step of the program (float32, through `make_train_step`) and
    of the reference from the same state, batch and draws: the losses, and
    every leaf's gradient norm (the momentum buffer after the step less the
    weight decay)."""
    from structure_knowledge_distillation_tpu_torch.config import TrainConfig
    from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

    n, size = 4, (256, 256)
    specs = {"teacher": archs.spec_of({"arch": "pspnet", "block": "bottleneck",
                                       "layers": (1, 1, 1, 1)}, C),
             "student": archs.spec_of({"arch": "resnet18", "block": "basic",
                                       "layers": (2, 2, 2, 2)}, C),
             "disc": nets.disc_spec(C, 33, 16)}
    g = torch.Generator().manual_seed(4)
    st = {k: weights.make_state(v, g, "cpu") for k, v in specs.items()}
    x = _images(n, size, 2)
    y = inputs.labels(inputs.make_generator("cpu", 2, 1), n, size, C, {}, "cpu")
    weights.calibrate(specs["teacher"], st["teacher"], x)
    cfg = TrainConfig(data_set="synthetic", classes_num=C, batch_size=n, input_size=size,
                      compute_dtype="float32", teacher_layers=(1, 1, 1, 1), ho=ho,
                      imsize_for_adv=33, adv_conv_dim=16, device="cpu", log_path="")
    tr = KDTrainer(cfg, teacher_state=st["teacher"], student_state=st["student"],
                   d_state=st["disc"])
    gen = torch.Generator().manual_seed(11)
    m = tr.train_step(tr.state, x, y, gen)
    recipe = kd_step.Recipe(dict(classes=C, pi=True, pa=True, ho=ho))
    dg = torch.Generator().manual_seed(11)
    out = kd_step.ref_steps(specs, {**st, "g_buf": {}, "d_buf": {}}, [(x, y.long())], recipe,
                            precision.Exact(), lambda s: torch.rand(s, generator=dg), 0)
    r = out["losses"][0]
    assert float(m["g_loss"]) == pytest.approx(r["g_loss"], rel=1e-4)
    if ho:
        assert float(m["d_loss"]) == pytest.approx(r["d_loss"], rel=1e-3)
    mods = (("student", tr.student, tr.state.g_opt),) + (
        (("disc", tr.discriminator, tr.state.d_opt),) if ho else ())
    for mod, module, opt in mods:
        ref = out["first_grads"][mod]
        norms = {k: float(v.norm()) for k, v in ref.items()}
        med = sorted(norms.values())[len(norms) // 2]
        for name, p in module.named_parameters():
            if norms[name] < 1e-3 * med:
                continue  # moved by round-off alone
            got = (opt.state[p]["momentum_buffer"] - 1e-4 * st[mod][name]).norm()
            assert abs(float(got) - norms[name]) <= 1e-2 * max(norms[name], med), name


def test_val_class_maps_match_k1_plain():
    from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
        upsampled_argmax,
    )

    logits = torch.randn(1, C, 17, 33, generator=torch.Generator().manual_seed(1))
    ref = nets.up(logits, (128, 256)).argmax(1)
    got = upsampled_argmax(logits, (128, 256))
    assert float((got != ref).float().mean()) < 1e-3
