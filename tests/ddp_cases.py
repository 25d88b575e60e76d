"""Shared cases of the data-parallel tests (tests/test_torch_port_ddp_*.py).

The rank functions here run in the processes that the port's own launcher
(`parallel.launch`) spawns, over gloo on the CPU, each with one torch thread.
They import the port only: the JAX references run in the pytest process, and
this module imports JAX inside those functions alone, so a spawned rank that
imports it stays light.

The step cases follow tests/test_torch_port_train_step.py (R101-style
bottleneck teacher and basic student at layers (1,1,1,1), width 0.25, 7
classes, 256² crops, 33² logits, SAGAN D with conv_dim 16 and its
BatchNorm2d preprocess, f32, dropout off) at the global batch 8 over 4
ranks of 2. The labels ignore about 90 % of rank 0's pixels and none of the
others', so a CE averaged per rank and then over ranks differs from the
global Σloss/Σvalid.

Each rank's step is held against the JAX step twice: the parameters at the
tolerances of the JAX package's invariance test, and each tensor's update
(new − old) within the one-step envelope of the port's step test
(tests/test_torch_port_train_step.py: 6 % of the tensor's largest update
elementwise, 2 % relative L2, cosine > 0.999).

The step is sized so that those tolerances test the step and not f32
rounding: G lr 2.5e-4 (the one-process step tests take 1e-2) and λ_pi 1
(the hinge case takes 10). With the random teacher, Pi at λ 10 is 99 % of
the G loss, and the step's result then depends on the order of its f32
sums: reordering the global batch of one process moves the stem's update by
0.26 % of its norm (measured, through the BN backward's cancellations), and
a rank's partial sums are one more such order. At lr 1e-2 an update is 15 %
of the stem's weights, so a parameter tolerance of 2e-3 would test that
rounding. At λ_pi 1 and lr 2.5e-4 the 4-rank chunk and the one-process
chunk agree within 1e-5 relative (two steps, measured 0.9 of it at the
stem); the update envelope is scale-free. A wrong share or a missing
collective moves an update by a whole term.
"""

from __future__ import annotations

import numpy as np
import torch

WORLD = 4
BATCH = 8
CLASSES = 7
LAYERS = (1, 1, 1, 1)
WIDTH = 0.25
CROP = 256
# the tolerances of the JAX package's data-parallel invariance test
# (tests/test_train_step.py::test_data_parallel_invariance)
METRIC_TOL = dict(rtol=2e-3, atol=1e-5)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=2e-3, atol=1e-5)
STATS_LEAVES = ("running_mean", "running_var")
STEP_OVER = dict(lr_g=2.5e-4, lambda_pi=1.0)  # shared by the port's and the JAX config


def cfg_kwargs(adv_type: str = "wgan-gp", **over) -> dict:
    """The port's TrainConfig fields of the step cases (no `device`)."""
    kw = dict(classes_num=CLASSES, batch_size=BATCH, input_size=(CROP, CROP),
              imsize_for_adv=33, adv_conv_dim=16, num_steps=4, pi=True, pa=True, ho=True,
              adv_loss_type=adv_type, lambda_pa=0.7, lambda_d=0.13,
              lambda_gp=10.0, pool_scale=0.5, compute_dtype="float32", num_data_shards=WORLD,
              **STEP_OVER)
    kw.update(over)
    return kw


def step_batch(seed: int = 42, steps: int = 1):
    """(images (steps, 8, 256, 256, 3) f32 NHWC, labels (steps, 8, 256, 256)
    int32): images of different contrast (a well-conditioned f32 BN, as in
    the one-process step test), rank 0's labels (images 0 and 1) 90 %
    ignored, the others' not at all."""
    rng = np.random.RandomState(seed)
    images = rng.randn(steps, BATCH, CROP, CROP, 3).astype(np.float32)
    scale = (0.5 + 0.5 * np.arange(BATCH)).astype(np.float32)
    images = images * scale[None, :, None, None, None]
    labels = rng.randint(0, CLASSES, (steps, BATCH, CROP, CROP)).astype(np.int32)
    labels[:, :BATCH // WORLD][rng.rand(steps, BATCH // WORLD, CROP, CROP) < 0.9] = 255
    return images, labels


def _train_state(payload: dict):
    """(cfg, KDTrainState) of the port from the payload's numpy state dicts,
    on the CPU."""
    from structure_knowledge_distillation_tpu_torch.config import TrainConfig
    from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
    from structure_knowledge_distillation_tpu_torch.training.train_state import (
        KDTrainState,
        make_sgd,
        poly_schedule,
    )

    cfg = TrainConfig(**payload["cfg"], device="cpu")
    fused, drop = payload.get("bn_fused", False), payload.get("drop_rate", 0.0)
    gen = torch.Generator().manual_seed(payload.get("init_seed", 0))
    teacher = ResPSPNet("bottleneck", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=drop,
                        bn_fused=fused, generator=gen)
    student = ResPSPNet("basic", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=drop,
                        bn_fused=fused, generator=gen)
    disc = Discriminator(CLASSES, preprocess_mode=1, image_size=33, conv_dim=16, generator=gen)
    for model, key in ((teacher, "teacher"), (student, "student"), (disc, "disc")):
        if key in payload:
            model.load_state_dict({k: torch.tensor(v) for k, v in payload[key].items()},
                                  strict=True)
    teacher.requires_grad_(False)
    state = KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
    return cfg, state


def _numpy_sd(model) -> dict:
    return {k: v.detach().numpy().copy() for k, v in model.state_dict().items()}


def _result(state, metrics) -> dict:
    def moms(opt, module):
        return [opt.state[p]["momentum_buffer"].numpy().copy() for p in module.parameters()
                if p.requires_grad and "momentum_buffer" in opt.state[p]]

    return {"metrics": {k: np.asarray(v.detach()).copy() for k, v in metrics.items()},
            "student": _numpy_sd(state.student), "disc": _numpy_sd(state.discriminator),
            "g_mom": moms(state.g_opt, state.student),
            "d_mom": moms(state.d_opt, state.discriminator)}


def run_step(payload: dict, group=None) -> dict:
    """One step (or, with `unroll`, one chunk through the multi-step loop)
    of the payload's case: the whole batch without a group, this rank's rows
    with one. Returns the metrics, both models' state dicts and the momentum
    buffers as numpy."""
    from structure_knowledge_distillation_tpu_torch.ops.batch_norm import set_process_group
    from structure_knowledge_distillation_tpu_torch.parallel import shard_rows, world_of
    from structure_knowledge_distillation_tpu_torch.training.train_step import (
        make_train_loop,
        make_train_step,
    )

    rank, world = world_of(group)
    cfg, state = _train_state(payload)
    if group is not None:
        set_process_group(state.student, group)
        set_process_group(state.discriminator, group)
    images = torch.from_numpy(payload["images"]).permute(0, 1, 4, 2, 3).contiguous()
    labels = torch.from_numpy(payload["labels"])
    generator = torch.Generator().manual_seed(payload.get("draw_seed", 0))
    if group is not None:
        images = torch.stack([shard_rows(x, rank, world) for x in images])
        labels = torch.stack([shard_rows(x, rank, world) for x in labels])
    if "unroll" in payload:
        loop = make_train_loop(cfg, payload["unroll"], group)
        metrics = loop(state, images, labels, images.shape[0], generator)
    else:
        alpha = payload.get("alpha")
        if alpha is not None:
            alpha = torch.from_numpy(alpha)
            if group is not None:
                alpha = shard_rows(alpha, rank, world)
        metrics = make_train_step(cfg, group)(state, images[0], labels[0], generator, alpha)
    return _result(state, metrics)


def rank_step(group, payload: dict) -> dict:
    """The rank function of the step cases."""
    torch.set_num_threads(1)
    return run_step(payload, group)


def rank_ohem(group, payload: dict, logits: np.ndarray, labels: np.ndarray, kw: dict) -> dict:
    """The OHEM case's rank function: the threshold and this rank's share of
    `ohem_cross_entropy` on its rows of (logits, labels), then the step."""
    from structure_knowledge_distillation_tpu_torch.losses.ohem import (
        ohem_cross_entropy,
        ohem_threshold,
    )
    from structure_knowledge_distillation_tpu_torch.parallel import shard_rows, world_of

    torch.set_num_threads(1)
    rank, world = world_of(group)
    x = shard_rows(torch.from_numpy(logits), rank, world)
    y = shard_rows(torch.from_numpy(labels), rank, world)
    out = run_step(payload, group)
    out["threshold"] = float(ohem_threshold(x, y, group=group, **kw))
    out["ohem_share"] = float(ohem_cross_entropy(x, y, group=group, **kw))
    return out


BN_KINDS = {"abn": dict(activation="leaky_relu"), "abn_fused": dict(activation="leaky_relu",
                                                                    fused=True),
            "batchnorm2d": {}}


def run_bn(x: np.ndarray, dz: np.ndarray, weight: np.ndarray, bias: np.ndarray,
           group=None) -> dict:
    """Train-mode ABN (unfused and fused, leaky_relu) and BatchNorm2d on
    (x, dz) NCHW (this rank's rows with a group): per kind the output, dx,
    the parameter gradients summed over the ranks (as the train step sums
    them), and the running statistics after the update."""
    from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
        ABN,
        BatchNorm2d,
        set_process_group,
    )
    from structure_knowledge_distillation_tpu_torch.parallel import (
        all_reduce_sum,
        shard_rows,
        world_of,
    )

    rank, world = world_of(group)
    xt, dzt = torch.from_numpy(x), torch.from_numpy(dz)
    if group is not None:
        xt, dzt = shard_rows(xt, rank, world), shard_rows(dzt, rank, world)
    out = {}
    for kind, kw in BN_KINDS.items():
        c = x.shape[1]
        mod = BatchNorm2d(c) if kind == "batchnorm2d" else ABN(c, **kw)
        set_process_group(mod, group)
        with torch.no_grad():
            mod.weight.copy_(torch.from_numpy(weight))
            mod.bias.copy_(torch.from_numpy(bias))
        xin = xt.clone().requires_grad_(True)
        z = mod(xin)
        dx, dw, db = torch.autograd.grad(z, [xin, mod.weight, mod.bias], dzt)
        if group is not None:
            dw, db = all_reduce_sum([dw, db], group)
        out[kind] = {k: v.detach().numpy().copy() for k, v in dict(
            z=z, dx=dx, dweight=dw, dbias=db, running_mean=mod.running_mean,
            running_var=mod.running_var).items()}
    return out


def gp_inputs():
    """The double-backward case: (x (8, 3, 2, 2), w_out (3, 2, 2), weight,
    bias), 32 values a channel, so the batch means enter the penalty's
    gradient at a few percent."""
    rng = np.random.RandomState(9)
    x = (rng.randn(BATCH, 3, 2, 2) * 1.5 + 0.5).astype(np.float32)
    w_out = rng.randn(3, 2, 2).astype(np.float32)
    weight = (rng.randn(3) + 1.0).astype(np.float32)
    bias = (0.2 * rng.randn(3)).astype(np.float32)
    return x, w_out, weight, bias


def run_gp(x, w_out, weight, bias, group=None) -> dict:
    """The WGAN-GP's shape through the synced BatchNorm2d: f = Σ w_out ·
    leaky_relu(BN(x)), g = ∂f/∂x (create_graph), gp = mean over the global
    batch of (‖g_n‖ − 1)²; returns this rank's ∂gp/∂x and ∂gp/∂(weight,
    bias, w_out) summed over the ranks."""
    import torch.nn.functional as F

    from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
        BatchNorm2d,
        set_process_group,
    )
    from structure_knowledge_distillation_tpu_torch.parallel import (
        all_reduce_sum,
        shard_rows,
        world_of,
    )

    rank, world = world_of(group)
    mod = BatchNorm2d(x.shape[1])
    set_process_group(mod, group)
    with torch.no_grad():
        mod.weight.copy_(torch.from_numpy(weight))
        mod.bias.copy_(torch.from_numpy(bias))
    w = torch.from_numpy(w_out).requires_grad_(True)
    xin = shard_rows(torch.from_numpy(x), rank, world).clone().requires_grad_(True)
    f = (w * F.leaky_relu(mod(xin), 0.2)).sum()
    (g,) = torch.autograd.grad(f, xin, create_graph=True)
    gp = ((g.reshape(g.shape[0], -1).norm(dim=1) - 1.0) ** 2).sum() / x.shape[0]
    dx, dw, db, dwo = torch.autograd.grad(gp, [xin, mod.weight, mod.bias, w])
    if group is not None:
        dw, db, dwo = all_reduce_sum([dw, db, dwo], group)
    return {k: v.detach().numpy().copy() for k, v in dict(dx=dx, dweight=dw, dbias=db,
                                                          dw_out=dwo).items()}


def rank_bn(group, x, dz, weight, bias) -> dict:
    """The sync-BN case's rank function, with the helpers' own checks:
    `gather_rows` (rank order), `broadcast_state` (rank 0's values) and
    `shard_rows`."""
    from structure_knowledge_distillation_tpu_torch.parallel import (
        broadcast_state,
        gather_rows,
        shard_rows,
        world_of,
    )

    torch.set_num_threads(1)
    rank, world = world_of(group)
    out = run_bn(x, dz, weight, bias, group)
    out["gp"] = run_gp(*gp_inputs(), group=group)
    rows = torch.full((2, 3), float(rank))
    gathered = gather_rows(rows, group)
    state = [torch.full((4,), float(rank + 1)), torch.arange(3, dtype=torch.int64) * (rank + 1)]
    broadcast_state(state, group)
    out["helpers"] = {"gathered": gathered.numpy(), "broadcast": [t.numpy() for t in state],
                      "shard": shard_rows(torch.arange(8), rank, world).numpy()}
    return out


class FrameList:
    """Val frames in memory, indexable as a dataset: (image HWC f32, label
    HW int32, size [h, w, 3], name)."""

    def __init__(self, frames: list):
        self.frames = frames

    def __len__(self) -> int:
        return len(self.frames)

    def __getitem__(self, i: int):
        return self.frames[i]


EVAL_SWEEPS = {"f32": {}, "u8": {"u8": True}, "msf-f32": {"msf": True},
               "msf-u8": {"msf": True, "u8": True}}
MSF = ((0.75, 1.0, 1.25), True)


def rank_eval(group, state_dict: dict, frames: list, size: tuple, classes: int) -> dict:
    """The sharded sweep's rank function: this rank's frames of every group
    of `world` (`data.EvalShard`) through `evaluate_sharded` with the group,
    for each sweep of EVAL_SWEEPS; returns each sweep's all-reduced
    confusion."""
    from structure_knowledge_distillation_tpu_torch.data import (
        IMG_MEAN_BGR,
        EvalShard,
        batch_iterator,
    )
    from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
    from structure_knowledge_distillation_tpu_torch.parallel import world_of
    from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_sharded

    torch.set_num_threads(1)
    rank, world = world_of(group)
    model = ResPSPNet("basic", LAYERS, classes, width_mult=WIDTH)
    model.load_state_dict({k: torch.tensor(v) for k, v in state_dict.items()}, strict=True)
    model.eval()
    out = {}
    for name, sweep in EVAL_SWEEPS.items():
        scales, flip = MSF if sweep.get("msf") else ((1.0,), False)
        loader = batch_iterator(EvalShard(FrameList(frames), rank, world), 1, shuffle=False)
        out[name] = evaluate_sharded(
            model, loader, classes, out_size=size, batch=world, scales=scales, flip=flip,
            input_mean=IMG_MEAN_BGR if sweep.get("u8") else None, group=group)[2]
    return out


def rank_cli_sigterm(group, argv: list, kill_rank: int, kill_step: int) -> float:
    """`cli.train.main(argv)` as one rank of a launched group, with a SIGTERM
    sent to rank `kill_rank`'s own process once its train state reaches
    `kill_step` (the notice arrives between two steps, on one rank only)."""
    import os
    import signal

    import torch.distributed as dist

    from structure_knowledge_distillation_tpu_torch.cli import train as cli_train
    from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

    torch.set_num_threads(1)
    train = KDTrainer._train

    def train_then_notice(self, batch, n_valid):
        out = train(self, batch, n_valid)
        if dist.get_rank(group) == kill_rank and self.state.step == kill_step:
            os.kill(os.getpid(), signal.SIGTERM)
        return out

    KDTrainer._train = train_then_notice
    return cli_train.main(argv)


def rank_fails(group, bad_rank: int) -> None:
    """Rank `bad_rank` raises; the others wait for it in an all-reduce."""
    if torch.distributed.get_rank(group) == bad_rank:
        raise ValueError("this rank fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1), group=group)


def rank_build(group, cfg_kwargs: dict) -> dict:
    """A `KDTrainer` built as one rank: its rank, world and device, which
    modules' ABNs sync over the group, and its student and D state."""
    from structure_knowledge_distillation_tpu_torch.config import TrainConfig
    from structure_knowledge_distillation_tpu_torch.ops.batch_norm import ABN
    from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

    torch.set_num_threads(1)
    trainer = KDTrainer(TrainConfig(**cfg_kwargs))

    def synced(module):
        return sorted({m.process_group is group for m in module.modules() if isinstance(m, ABN)})

    return {"rank": trainer.rank, "world": trainer.world, "device": str(trainer.device),
            "synced": {name: synced(getattr(trainer, name))
                       for name in ("teacher", "student", "discriminator")},
            "student": _numpy_sd(trainer.student), "disc": _numpy_sd(trainer.discriminator),
            "generator": trainer.generator.get_state().numpy()}


def launch_step(payload: dict, world: int = WORLD) -> list:
    from structure_knowledge_distillation_tpu_torch.parallel import launch

    return launch(rank_step, world, payload, timeout=300)


def assert_ranks_identical(results: list) -> None:
    """Every rank holds the same parameters, buffers (running statistics,
    spectral u/v), momentum and metrics, bit for bit."""
    first = results[0]
    for r, res in enumerate(results[1:], 1):
        for part in ("student", "disc"):
            for k, v in first[part].items():
                assert np.array_equal(res[part][k], v), (r, part, k)
        for part in ("g_mom", "d_mom"):
            assert len(res[part]) == len(first[part])
            for a, b in zip(res[part], first[part]):
                assert np.array_equal(a, b), (r, part)
        for k, v in first["metrics"].items():
            assert np.array_equal(res["metrics"][k], v), (r, k)


# ------------------------------------------------------------ the JAX side
def jax_reference(adv_type: str = "wgan-gp", seed: int = 42, **cfg_over) -> tuple:
    """The JAX step jitted on a 4-device `data` mesh at the global batch 8
    (the construction of tests/test_train_step.py::
    test_data_parallel_invariance), from randomised weights. Returns (payload
    of the port's case, JAX metrics, JAX student and D state dicts after the
    step under the reference's torch names). The JAX CE and ABN run unfused
    (`fused_ce` false, `bn_fused` false): the port's CPU CE is the same
    function, and so is its fused ABN (tests/test_torch_port_fused_bn.py
    holds the two ABN paths together), while the JAX fused ABN under the
    mesh runs its Pallas kernels in interpret mode (106 s for this step
    here)."""
    import jax
    import jax.numpy as jnp
    from test_torch_port_train_step import _cfg_kwargs, _randomized_vars

    from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
    from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
    from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
    from structure_knowledge_distillation_tpu.parallel import (
        batch_sharding,
        make_mesh,
        shard_state,
    )
    from structure_knowledge_distillation_tpu.training import create_train_state
    from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
    from structure_knowledge_distillation_tpu.training import (
        make_train_step as jax_make_train_step,
    )
    from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

    images, labels = step_batch(seed)
    rng = np.random.RandomState(seed + 1)
    jkw = {**_cfg_kwargs(adv_type), "batch_size": BATCH, **STEP_OVER, **cfg_over}
    jcfg = JaxTrainConfig(**jkw, fused_ce="false")
    teacher = JaxResPSPNet(block="bottleneck", layers=LAYERS, num_classes=CLASSES,
                           drop_rate=0.0, width_mult=WIDTH)
    student = JaxResPSPNet(block="basic", layers=LAYERS, num_classes=CLASSES,
                           drop_rate=0.0, width_mult=WIDTH)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=16)
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(images[0, :1])
    t_vars = _randomized_vars(rng, teacher.init(key, x0, train=False))
    s_vars = _randomized_vars(rng, student.init(key, x0, train=False))
    d_vars = _randomized_vars(rng, disc.init(key, jnp.zeros((1, 33, 33, CLASSES)), train=False))
    g_tx = jax_make_sgd(jcfg.lr_g, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    d_tx = jax_make_sgd(jcfg.lr_d, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    state = create_train_state(jax.random.PRNGKey(7), t_vars, s_vars, d_vars, g_tx, d_tx)
    _, gp_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    alpha = np.asarray(jax.random.uniform(gp_rng, (BATCH, 1, 1, 1), jnp.float32))

    def export(st):
        return (tckpt.state_dict_from_jax({"params": st.student_params,
                                           "batch_stats": st.student_stats}),
                tckpt.discriminator_state_dict_from_jax({"params": st.d_params,
                                                         "batch_stats": st.d_stats,
                                                         "spectral": st.d_spectral}))

    student_sd, disc_sd = export(state)
    mesh = make_mesh(num_data=WORLD, num_model=1)
    bs = batch_sharding(mesh)
    step = jax.jit(jax_make_train_step(jcfg, teacher, student, disc, g_tx, d_tx))
    new_state, metrics = step(shard_state(state, mesh), jax.device_put(images[0], bs),
                              jax.device_put(labels[0], bs))
    payload = {"cfg": cfg_kwargs(adv_type, **cfg_over), "teacher": tckpt.state_dict_from_jax(t_vars), "student": student_sd,
               "disc": disc_sd, "images": images, "labels": labels, "alpha": alpha}
    jax_student, jax_disc = export(new_state)
    return payload, {k: float(v) for k, v in metrics.items()}, jax_student, jax_disc


def _compare_updates(after_jax: dict, before: dict, after_port: dict, label: str) -> None:
    """The one-step envelope of tests/test_torch_port_train_step.py on the
    updates (new − old) of the parameters, with a floor: a tensor whose
    update is under 1e-3 of the model's whole update norm carries the
    rounding of the rest (D's BN bias, a sum that nearly cancels, moves by
    3e-6 against 1e-2), so it is held by the parameter tolerance alone."""
    keys = sorted(k for k in after_jax
                  if not k.endswith(STATS_LEAVES + ("weight_u", "weight_v")))
    upd = {k: (after_port[k] - before[k], after_jax[k] - before[k]) for k in keys}
    floor = 1e-3 * np.linalg.norm(np.concatenate([dt.ravel() for dt, _ in upd.values()]))
    for k, (dt, dj) in upd.items():
        nt = np.linalg.norm(dt)
        if nt <= floor:
            continue
        scale = max(np.abs(dt).max(), np.abs(dj).max())
        np.testing.assert_allclose(dj, dt, rtol=0, atol=6e-2 * scale, err_msg=f"{label}:{k}")
        assert np.linalg.norm(dj - dt) < 2e-2 * nt, (label, k)
        cos = float(np.dot(dj.ravel(), dt.ravel()) / (np.linalg.norm(dj) * nt))
        assert cos > 0.999, (label, k, cos)


def assert_step_matches_jax(result: dict, payload: dict, jax_metrics: dict,
                            jax_student: dict, jax_disc: dict) -> None:
    """A rank's step against the JAX sharded step (see the module's
    docstring)."""
    assert sorted(result["metrics"]) == sorted(jax_metrics)
    for k, v in jax_metrics.items():
        np.testing.assert_allclose(float(result["metrics"][k]), v, **METRIC_TOL, err_msg=k)
    for name, ours, ref in (("student", result["student"], jax_student),
                            ("disc", result["disc"], jax_disc)):
        assert sorted(ours) == sorted(ref), name
        for k, v in ref.items():
            tol = STATS_TOL if k.endswith(STATS_LEAVES) else PARAM_TOL
            np.testing.assert_allclose(ours[k], np.asarray(v), **tol, err_msg=f"{name}:{k}")
        before = {k: np.asarray(v) for k, v in payload[name].items()}
        _compare_updates({k: np.asarray(v) for k, v in ref.items()}, before, ours, name)
