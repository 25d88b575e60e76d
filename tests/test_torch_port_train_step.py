"""The ported KD train step vs the JAX `make_train_step`, and `cli.train`.

Both sides start from the same randomised weights (JAX init, crossed over
with `state_dict_from_jax` / `discriminator_state_dict_from_jax`) and take
the same numpy batches: a small teacher (Bottleneck) and student (Basic),
layers (1,1,1,1) at width 0.25, 7 classes, batch 2, 256² crops (33²
logits), `imsize_for_adv` 33, `adv_conv_dim` 16, f32, dropout off (masks
cannot be shared across frameworks). The JAX step runs the DSN loss through
its Pallas kernels K4/K5 in interpret mode (`fused_ce="true"`); the port's
fused criterion takes its plain versions on the CPU. The GP's α is the JAX
step's own, fed to the port.

Tolerances are the envelope of tests/test_composite_step_oracle.py, which
calibrated them to the measured chaotic drift of two f32 GAN trajectories
whose reductions run in different orders: per-step losses within
rtol (2e-3, 5e-2, 1e-1) / atol (2e-4, 2e-2, 5e-2) at steps 1, 2, 3; after one
step every parameter update within 6 % of the tensor's largest update, 2 %
relative L2 and cosine > 0.999; after three steps 30 % relative L2 and
cosine > 0.90, with the floor of that test for tensors that carry a sliver of
the whole update.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import create_train_state
from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training import make_train_step as jax_make_train_step
from structure_knowledge_distillation_tpu_torch.cli import train as port_cli
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step

CLASSES = 7
LAYERS = (1, 1, 1, 1)
WIDTH = 0.25
N_STEPS = 3
LOSS_RTOL = (2e-3, 5e-2, 1e-1)
LOSS_ATOL = (2e-4, 2e-2, 5e-2)
STATE_LEAVES = ("running_mean", "running_var", "weight_u", "weight_v")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of one thread per core in each of them oversubscribes the host
    (small steps then take many times longer), so these tests take two."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _cfg_kwargs(adv_type):
    # a short schedule: the poly lr decays 25 % a step, so a frozen or
    # mis-offset schedule moves the trajectory by far more than the drift
    return dict(classes_num=CLASSES, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                adv_conv_dim=16, num_steps=4, pi=True, pa=True, ho=True,
                adv_loss_type=adv_type, lambda_pi=10.0, lambda_pa=0.7, lambda_d=0.13,
                lambda_gp=10.0, pool_scale=0.5, compute_dtype="float32")


def _randomized_vars(rng, template):
    """Signed ABN weights, small random biases, random running statistics and
    unit spectral vectors; conv kernels keep their init."""
    def param(path, a):
        if a.ndim == 1 and path[-1].key == "weight":
            sign = np.where(rng.rand(*a.shape) < 0.25, -1.0, 1.0)
            return jnp.asarray((sign * (rng.rand(*a.shape) + 0.5)).astype(np.float32))
        if a.ndim == 1 and path[-1].key == "gamma":
            return jnp.asarray((0.5 * rng.rand(*a.shape)).astype(np.float32))
        if a.ndim == 1:
            return jnp.asarray((rng.randn(*a.shape) * 0.1).astype(np.float32))
        return a

    out = {"params": jax.tree_util.tree_map_with_path(param, template["params"])}
    if "batch_stats" in template:
        out["batch_stats"] = jax.tree_util.tree_map_with_path(
            lambda path, a: jnp.asarray(
                (rng.randn(*a.shape) * 0.1).astype(np.float32) if path[-1].key == "mean"
                else (rng.rand(*a.shape) + 0.5).astype(np.float32)),
            template["batch_stats"])
    if "spectral" in template:
        out["spectral"] = jax.tree.map(
            lambda a: jnp.asarray((lambda v: v / np.linalg.norm(v))(
                rng.randn(*a.shape).astype(np.float32))), template["spectral"])
    return out


def _numpy_sd(model):
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


@pytest.fixture(scope="module", params=[("wgan-gp", False), ("hinge", False), ("wgan-gp", True)],
                ids=["wgan-gp", "hinge", "wgan-gp-bn_fused"])
def run(request):
    """Three steps of both packages from the same start; returns the losses
    per step and the state dicts at the start, after step 1 and after step 3.
    With `bn_fused`, teacher and student take the fused ABN on both sides
    (the JAX Pallas kernels K6–K8 in interpret mode, the port's plain
    versions of its kernels on the CPU)."""
    adv_type, bn_fused = request.param
    rng = np.random.RandomState(42)
    images_k = rng.randn(N_STEPS, 2, 256, 256, 3).astype(np.float32)
    # the two images of a batch differ in contrast and brightness, as real
    # frames do: two iid noise images pool to nearly equal PSP bins, and the
    # train-mode BN over those 2-sample bins (variance far below eps) turns
    # f32 rounding into percent-level gradient noise on both sides
    images_k[:, 1] = 3.0 * images_k[:, 1] + 1.0
    labels_k = rng.randint(0, CLASSES, (N_STEPS, 2, 256, 256)).astype(np.int32)
    labels_k[:, 0, :16] = 255

    jcfg = JaxTrainConfig(**_cfg_kwargs(adv_type), fused_ce="true")
    teacher = JaxResPSPNet(block="bottleneck", layers=LAYERS, num_classes=CLASSES,
                           drop_rate=0.0, width_mult=WIDTH, bn_fused=bn_fused)
    student = JaxResPSPNet(block="basic", layers=LAYERS, num_classes=CLASSES,
                           drop_rate=0.0, width_mult=WIDTH, bn_fused=bn_fused)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=16)
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(images_k[0, :1])
    t_vars = _randomized_vars(rng, teacher.init(key, x0, train=False))
    s_vars = _randomized_vars(rng, student.init(key, x0, train=False))
    d_vars = _randomized_vars(rng, disc.init(key, jnp.zeros((1, 33, 33, CLASSES)), train=False))
    g_tx = jax_make_sgd(jcfg.lr_g, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    d_tx = jax_make_sgd(jcfg.lr_d, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    state = create_train_state(jax.random.PRNGKey(7), t_vars, s_vars, d_vars, g_tx, d_tx)
    rng0 = state.rng
    step_fn = jax.jit(jax_make_train_step(jcfg, teacher, student, disc, g_tx, d_tx))

    def export(st):
        return ({**tckpt.state_dict_from_jax({"params": st.student_params,
                                              "batch_stats": st.student_stats})},
                tckpt.discriminator_state_dict_from_jax({"params": st.d_params,
                                                         "batch_stats": st.d_stats,
                                                         "spectral": st.d_spectral}))

    jax_sds, jax_losses = [export(state)], []
    for i in range(N_STEPS):
        state, metrics = step_fn(state, jnp.asarray(images_k[i]), jnp.asarray(labels_k[i]))
        jax_losses.append({k: float(v) for k, v in metrics.items()})
        jax_sds.append(export(state))

    # --- the port, from the same weights
    cfg = TrainConfig(**_cfg_kwargs(adv_type), device="cpu")
    t_model = ResPSPNet("bottleneck", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=0.0,
                        bn_fused=bn_fused)
    s_model = ResPSPNet("basic", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=0.0,
                        bn_fused=bn_fused)
    d_model = Discriminator(CLASSES, preprocess_mode=1, image_size=33, conv_dim=16)
    for model, sd in ((t_model, tckpt.state_dict_from_jax(t_vars)),
                      (s_model, jax_sds[0][0]), (d_model, jax_sds[0][1])):
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    t_model.requires_grad_(False)
    pstate = KDTrainState(
        teacher=t_model, student=s_model, discriminator=d_model,
        g_opt=make_sgd(s_model.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(d_model.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    train_step = make_train_step(cfg)
    port_sds, port_losses = [(_numpy_sd(s_model), _numpy_sd(d_model))], []
    for i in range(N_STEPS):
        _, gp_rng = jax.random.split(jax.random.fold_in(rng0, i))
        alpha = torch.tensor(np.asarray(jax.random.uniform(gp_rng, (2, 1, 1, 1), jnp.float32)))
        images = torch.from_numpy(images_k[i].transpose(0, 3, 1, 2).copy())
        metrics = train_step(pstate, images, torch.from_numpy(labels_k[i]), alpha=alpha)
        port_losses.append({k: float(v) for k, v in metrics.items()})
        port_sds.append((_numpy_sd(s_model), _numpy_sd(d_model)))
    assert pstate.step == N_STEPS
    return adv_type, jax_losses, jax_sds, port_losses, port_sds


def _compare_updates(after_jax, before, after_port, n_steps, label):
    """The envelope of test_composite_step_oracle.py on UPDATES (new − old),
    where a wrong λ, detach or order shows at full magnitude."""
    if n_steps == 1:
        elem_tol, rel_tol, cos_tol = 6e-2, 2e-2, 0.999
    else:
        elem_tol, rel_tol, cos_tol = None, 3e-1, 0.90
    keys = sorted(k for k in after_jax if not k.endswith(STATE_LEAVES))
    gnorm = np.linalg.norm(np.concatenate([(after_port[k] - before[k]).ravel() for k in keys]))
    floor = 0.0 if n_steps == 1 else 2e-2 * gnorm
    for k in keys:
        dj = after_jax[k] - before[k]
        dt = after_port[k] - before[k]
        if elem_tol is not None:
            scale = max(np.abs(dt).max(), np.abs(dj).max(), 1e-12)
            np.testing.assert_allclose(dj, dt, rtol=0, atol=max(elem_tol * scale, 1e-7),
                                       err_msg=f"{label}:{k}")
        nt = np.linalg.norm(dt)
        if nt > 1e-7:
            err = float(np.linalg.norm(dj - dt))
            assert err < max(rel_tol * nt, floor), (label, k, err / nt)
            cos = float(np.dot(dj.ravel(), dt.ravel()) / (np.linalg.norm(dj) * nt + 1e-30))
            if nt > floor:
                assert cos > cos_tol, (label, k, cos)
            elif nt > 0.1 * floor:
                assert cos > 0.5, (label, k, cos, "sub-floor direction")


def _compare_state(after_jax, after_port, label):
    """BN running statistics and spectral u/v, which every D application and
    student forward advances, agree in value."""
    for k in after_jax:
        if k.endswith(STATE_LEAVES):
            np.testing.assert_allclose(after_port[k], after_jax[k], rtol=2e-2, atol=2e-3,
                                       err_msg=f"{label}:{k}")


def test_one_step_matches_jax(run):
    adv_type, jax_losses, jax_sds, port_losses, port_sds = run
    assert sorted(port_losses[0]) == sorted(jax_losses[0])
    for k, v in jax_losses[0].items():
        np.testing.assert_allclose(port_losses[0][k], v, rtol=LOSS_RTOL[0], atol=LOSS_ATOL[0],
                                   err_msg=f"{adv_type} step0:{k}")
    for i, label in enumerate(("student", "discriminator")):
        _compare_updates(jax_sds[1][i], port_sds[0][i], port_sds[1][i], 1, label)
        _compare_state(jax_sds[1][i], port_sds[1][i], label)


def test_trajectory_matches_jax(run):
    """Three steps with a fresh batch each: momentum buffers, the per-step
    poly lr, BN running statistics and the spectral u/v chain carry across
    step boundaries."""
    adv_type, jax_losses, jax_sds, port_losses, port_sds = run
    for i in range(N_STEPS):
        for k, v in jax_losses[i].items():
            np.testing.assert_allclose(port_losses[i][k], v, rtol=LOSS_RTOL[i],
                                       atol=LOSS_ATOL[i], err_msg=f"{adv_type} step{i}:{k}")
    for i, label in enumerate(("student", "discriminator")):
        _compare_updates(jax_sds[N_STEPS][i], port_sds[0][i], port_sds[N_STEPS][i], N_STEPS,
                         label)


def test_poly_schedule_matches_jax():
    from structure_knowledge_distillation_tpu.training.train_state import (
        poly_schedule as jax_poly,
    )

    ours, ref = poly_schedule(1e-2, 40000, 0.9), jax_poly(1e-2, 40000, 0.9)
    for count in (0, 1, 2, 39998, 39999, 40000, 40005):
        assert ours(count) == float(ref(jnp.asarray(count))), count


SMALL = ["--data-set", "synthetic", "--input-size", "256,256", "--batch-size", "1",
         "--num-steps", "2", "--teacher-layers", "1,1,1,1", "--imsize-for-adv", "33",
         "--device", "cpu", "--log-every", "1"]


def test_cli_train_synthetic_finishes_with_finite_losses(tmp_path):
    """The entry point end to end on the CPU: the full-width R18 student in
    the default bf16 compute, two steps and the in-training eval, with its
    metrics in `<log_path>/scalars.jsonl` and its checkpoints under the
    given directories."""
    best = port_cli.main(SMALL + ["--log-path", str(tmp_path / "log"),
                                  "--snapshot-dir", str(tmp_path / "snap"),
                                  "--S_ckpt_path", str(tmp_path / "student")])
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "g_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(math.isfinite(v) for v in r.values()), r
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [1]
    assert list((tmp_path / "snap").glob("CS_scenes_1_*.pth"))
    assert 0.0 <= best <= 1.0


def test_cli_train_synthetic_unrolled(tmp_path):
    """`--unroll-steps 2` over 3 steps: the host stacks chunks of two
    (`chunk_batches`), the trainer runs the chunk [1, 2] and the tail [3],
    and the reference cadence's eval at step 2 = num_steps - 1 comes after
    the first chunk."""
    port_cli.main(SMALL + ["--num-steps", "3", "--unroll-steps", "2",
                           "--log-path", str(tmp_path / "log"),
                           "--snapshot-dir", str(tmp_path / "snap"),
                           "--S_ckpt_path", str(tmp_path / "student")])
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "g_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        assert all(math.isfinite(v) for v in r.values()), r
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [2]
    assert list((tmp_path / "snap").glob("CS_scenes_2_*.pth"))


@pytest.mark.parametrize("flags,error,match", [
    (["--num-data-shards", "2"], ValueError, "not divisible"),
    (["--num-model-shards", "2"], NotImplementedError, "ROADMAP 'Not ported'"),
], ids=["data-shards-batch-1", "model-shards"])
def test_cli_train_unported_options_raise_naming_roadmap(flags, error, match):
    """`--num-data-shards 2` runs since data parallelism was ported
    (tests/test_torch_port_ddp_cli.py), but not with a global batch of 1,
    which does not split over two ranks; the model axis is not ported."""
    argv = SMALL + flags
    with pytest.raises(error, match=match):
        port_cli.main(argv)


@pytest.mark.parametrize("flags", [["--ohem", "true", "--ohem-min-kept", "6400"],
                                   ["--student-arch", "espnet"], ["--remat", "true"]],
                         ids=["ohem", "espnet", "remat"])
def test_cli_train_runs_the_item7_options(tmp_path, flags):
    """Options that raised before they were ported: the OHEM task loss
    (k = 100 < the 1/8 grid's 1024 valid pixels), the ESPNet-C student (its
    32×32 logits under the teacher's 33×33: the cross-family resize) and
    the rematerialised R18 student; two steps and the eval, finite losses.
    `--data-set voc` runs in tests/test_torch_port_item7.py."""
    port_cli.main(SMALL + flags + ["--log-path", str(tmp_path / "log"),
                                   "--snapshot-dir", str(tmp_path / "snap"),
                                   "--S_ckpt_path", str(tmp_path / "student")])
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "g_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(math.isfinite(v) for v in r.values()), r
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [1]


@pytest.mark.parametrize("flags", [["--flip", "true"], ["--wire-format", "u8"]],
                         ids=["flip", "wire-u8"])
def test_cli_train_runs_with_eval_and_wire_options(tmp_path, flags):
    """Options that used to raise: `--flip true` makes the in-training eval
    the flip-averaged sweep; `--wire-format u8` on synthetic data keeps the
    bf16 image wire (synthetic images are not integer−mean), as the JAX CLI
    does. Two steps and the eval, with finite losses."""
    best = port_cli.main(SMALL + flags + ["--log-path", str(tmp_path / "log"),
                                          "--snapshot-dir", str(tmp_path / "snap"),
                                          "--S_ckpt_path", str(tmp_path / "student")])
    with open(tmp_path / "log" / "scalars.jsonl") as f:
        rows = [json.loads(line) for line in f]
    steps = [r for r in rows if "g_loss" in r]
    assert [r["step"] for r in steps] == [1, 2]
    for r in steps:
        assert all(math.isfinite(v) for v in r.values()), r
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [1]
    assert 0.0 <= best <= 1.0
