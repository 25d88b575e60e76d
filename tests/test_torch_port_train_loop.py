"""The port's multi-step train loop (`make_train_loop`), its chunks and the
trainer's chunked run, on the CPU.

  * the port loop over a 3-step chunk against the JAX `make_train_loop` (a
    `lax.scan` of the JAX step) from crossed-over weights, dropout off and
    the JAX α fed: the setup and the tolerance envelope of
    tests/test_torch_port_train_step.py (per-step losses within rtol
    (2e-3, 5e-2, 1e-1), the three-step updates within 30 % relative L2 and
    cosine > 0.90);
  * the port loop against as many calls of the port's `train_step`, dropout
    on, from one generator state: bit for bit (parameters, momentum, spectral
    u/v, running statistics, metrics, the generator after), a tail chunk
    included: the two run the same code;
  * `Chunk`/`chunk_batches` against the JAX ones: stacking, tail padding,
    `n_valid`; `cast_batches` and `device_prefetch` carry a Chunk;
  * `KDTrainer.fit` with `unroll_steps=2` over 5 steps (2 chunks and a tail)
    equals `unroll_steps=1` bit for bit; an eval inside a chunk is logged
    under its step and checkpointed with the chunk's end as `state_step`;
  * SIGTERM at a chunk boundary, then a resume, equals the unbroken run;
  * `profile_dir` writes a `torch.profiler` trace.
"""

import copy
import json
import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_train_step import (
    CLASSES,
    LAYERS,
    LOSS_ATOL,
    LOSS_RTOL,
    WIDTH,
    _cfg_kwargs,
    _compare_updates,
    _numpy_sd,
    _randomized_vars,
    _two_threads,  # noqa: F401 (an autouse fixture)
)
from test_torch_port_trainer import _assert_same_run, _batches, _cfg

from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.data.prefetch import chunk_batches as jax_chunk_batches
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import create_train_state
from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training import make_train_step as jax_make_train_step
from structure_knowledge_distillation_tpu.training.train_step import (
    make_train_loop as jax_make_train_loop,
)
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import (
    Chunk,
    SyntheticSegDataset,
    batch_iterator,
    cast_batches,
    chunk_batches,
    device_prefetch,
)
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops.spectral import SNConv
from structure_knowledge_distillation_tpu_torch.training import checkpoint as ckpt
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

K = 3


def _chunk_inputs(seed=42):
    """(K, 2, 256, 256, 3) f32 images whose two frames differ in contrast (see
    tests/test_torch_port_train_step.py) and (K, 2, 256, 256) int32 labels
    with an ignored band."""
    rng = np.random.RandomState(seed)
    images_k = rng.randn(K, 2, 256, 256, 3).astype(np.float32)
    images_k[:, 1] = 3.0 * images_k[:, 1] + 1.0
    labels_k = rng.randint(0, CLASSES, (K, 2, 256, 256)).astype(np.int32)
    labels_k[:, 0, :16] = 255
    return images_k, labels_k


def _nchw(images_k):
    return torch.from_numpy(np.ascontiguousarray(images_k.transpose(0, 1, 4, 2, 3)))


def _port_state(cfg, sds, drop_rate, bn_fused=False, seed=0) -> KDTrainState:
    """The small models of tests/test_torch_port_train_step.py, loaded from
    (teacher, student, D) state dicts, or drawn from `seed` when None."""
    g = torch.Generator().manual_seed(seed)
    teacher = ResPSPNet("bottleneck", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=drop_rate,
                        bn_fused=bn_fused, generator=g)
    student = ResPSPNet("basic", LAYERS, CLASSES, width_mult=WIDTH, drop_rate=drop_rate,
                        bn_fused=bn_fused, generator=g)
    disc = Discriminator(CLASSES, preprocess_mode=1, image_size=33,
                         conv_dim=cfg.adv_conv_dim, generator=g)
    if sds is not None:
        for model, sd in zip((teacher, student, disc), sds):
            model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    teacher.requires_grad_(False)
    return KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def test_loop_matches_jax_scan_loop():
    """One 3-step chunk through the JAX `make_train_loop` (jitted lax.scan)
    and through the port's loop on the CPU, from the same weights."""
    images_k, labels_k = _chunk_inputs()
    jcfg = JaxTrainConfig(**_cfg_kwargs("wgan-gp"), fused_ce="true")
    teacher = JaxResPSPNet(block="bottleneck", layers=LAYERS, num_classes=CLASSES,
                           drop_rate=0.0, width_mult=WIDTH)
    student = JaxResPSPNet(block="basic", layers=LAYERS, num_classes=CLASSES, drop_rate=0.0,
                           width_mult=WIDTH)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=16)
    rng = np.random.RandomState(42)
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(images_k[0, :1])
    # one compiled init per model (op by op, the inits take most of a minute)
    t_vars, s_vars, d_vars = (
        _randomized_vars(rng, jax.jit(model.init, static_argnames="train")(key, x, train=False))
        for model, x in ((teacher, x0), (student, x0),
                         (disc, jnp.zeros((1, 33, 33, CLASSES)))))
    g_tx = jax_make_sgd(jcfg.lr_g, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    d_tx = jax_make_sgd(jcfg.lr_d, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    state = create_train_state(jax.random.PRNGKey(7), t_vars, s_vars, d_vars, g_tx, d_tx)
    # the JAX step's α at step i, fed to the port
    alpha_k = torch.stack([torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(state.rng, i))[1], (2, 1, 1, 1), jnp.float32)))
        for i in range(K)])
    loop = jax.jit(jax_make_train_loop(
        jax_make_train_step(jcfg, teacher, student, disc, g_tx, d_tx), K))

    def export(st):
        return (ckpt.state_dict_from_jax({"params": st.student_params,
                                           "batch_stats": st.student_stats}),
                ckpt.discriminator_state_dict_from_jax({"params": st.d_params,
                                                         "batch_stats": st.d_stats,
                                                         "spectral": st.d_spectral}))

    start = export(state)
    state, jax_metrics = loop(state, jnp.asarray(images_k), jnp.asarray(labels_k))
    jax_end = export(state)

    cfg = TrainConfig(**_cfg_kwargs("wgan-gp"), device="cpu")
    pstate = _port_state(cfg, (ckpt.state_dict_from_jax(t_vars), *start), drop_rate=0.0)
    port_metrics = make_train_loop(cfg, K)(pstate, _nchw(images_k), torch.from_numpy(labels_k),
                                           K, alpha_k=alpha_k)
    assert pstate.step == K
    assert sorted(port_metrics) == sorted(jax_metrics)
    for i in range(K):
        for name, v in jax_metrics.items():
            np.testing.assert_allclose(float(port_metrics[name][i]), float(v[i]),
                                       rtol=LOSS_RTOL[i], atol=LOSS_ATOL[i],
                                       err_msg=f"step{i}:{name}")
    port_end = (_numpy_sd(pstate.student), _numpy_sd(pstate.discriminator))
    for i, label in enumerate(("student", "discriminator")):
        _compare_updates(jax_end[i], start[i], port_end[i], K, label)


def _momenta(opt):
    return {i: s["momentum_buffer"] for i, s in opt.state_dict()["state"].items()}


def _assert_tensors_equal(a: dict, b: dict, what: str):
    assert sorted(a) == sorted(b), what
    for k in a:
        assert torch.equal(a[k], b[k]), f"{what}: {k}"


@pytest.mark.parametrize("adv_type,bn_fused,n_valid", [
    ("wgan-gp", False, K), ("hinge", False, K), ("wgan-gp", True, K), ("wgan-gp", False, 2)],
    ids=["wgan-gp", "hinge", "wgan-gp-bn_fused", "wgan-gp-tail"])
def test_loop_equals_eager_steps_bitwise(adv_type, bn_fused, n_valid):
    """Dropout on, one generator seed: the loop and `n_valid` calls of
    `train_step` take the same masks, α and lrs in the same order."""
    images_k, labels_k = _chunk_inputs(seed=3)
    cfg = TrainConfig(**_cfg_kwargs(adv_type), device="cpu")
    eager = _port_state(cfg, None, drop_rate=0.1, bn_fused=bn_fused, seed=5)
    looped = copy.deepcopy(eager)
    g_eager, g_loop = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    train_step = make_train_step(cfg)
    images, labels = _nchw(images_k), torch.from_numpy(labels_k)
    spectral = [(m.module, m.module.weight_u, m.module.weight_v)
                for m in looped.discriminator.modules() if isinstance(m, SNConv)]
    assert spectral
    steps = [train_step(eager, images[i], labels[i], g_eager) for i in range(n_valid)]
    metrics = make_train_loop(cfg, K)(looped, images, labels, n_valid, g_loop)

    assert eager.step == looped.step == n_valid
    for name, v in metrics.items():
        assert v.shape == (K,)
        want = torch.stack([m[name] for m in steps] + [torch.zeros(())] * (K - n_valid))
        assert torch.equal(v, want), name
    for attr in ("teacher", "student", "discriminator"):
        _assert_tensors_equal(getattr(eager, attr).state_dict(),
                              getattr(looped, attr).state_dict(), attr)
    for attr in ("g_opt", "d_opt"):
        _assert_tensors_equal(_momenta(getattr(eager, attr)), _momenta(getattr(looped, attr)),
                              attr)
        assert (getattr(eager, attr).param_groups[0]["lr"]
                == getattr(looped, attr).param_groups[0]["lr"])
    assert torch.equal(g_eager.get_state(), g_loop.get_state())
    # u/v are the tensors registered before the chunk again, holding its final values
    for holder, u, v in spectral:
        assert holder.weight_u is u and holder.weight_v is v


def _host_batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(size=(2, 4, 6, 3)).astype(np.float32),
             rng.integers(0, 19, (2, 4, 6)).astype(np.int32), f"batch{i}") for i in range(n)]


@pytest.mark.parametrize("n,unroll", [(6, 3), (7, 3), (2, 4), (1, 1)])
@pytest.mark.parametrize("kind", ["numpy", "torch"])
def test_chunk_batches_matches_jax(n, unroll, kind):
    batches = _host_batches(n)
    ref = list(jax_chunk_batches(iter(batches), unroll))
    if kind == "torch":
        batches = [(torch.from_numpy(a), torch.from_numpy(b), c) for a, b, c in batches]
    got = list(chunk_batches(iter(batches), unroll))
    assert len(got) == len(ref) == -(-n // unroll)
    for c, r in zip(got, ref):
        assert isinstance(c, Chunk)
        assert c.n_valid == r.n_valid
        assert c.images.shape == (unroll, 2, 4, 6, 3) and c.labels.shape == (unroll, 2, 4, 6)
        np.testing.assert_array_equal(np.asarray(c.images), r.images)
        np.testing.assert_array_equal(np.asarray(c.labels), r.labels)
    assert [c.n_valid for c in got][-1] == n - unroll * (len(got) - 1)


def test_cast_and_prefetch_carry_a_chunk():
    (chunk,) = chunk_batches(iter(_host_batches(3)), 4)
    (cast,) = cast_batches(iter([chunk]), torch.bfloat16, torch.uint8)
    assert isinstance(cast, Chunk) and cast.n_valid == 3
    assert cast.images.dtype == torch.bfloat16 and cast.labels.dtype == torch.uint8
    (moved,) = device_prefetch(iter([cast]), "cpu")
    assert isinstance(moved, Chunk) and moved.n_valid == 3
    assert moved.images.shape == (4, 2, 3, 4, 6) and moved.images.is_contiguous()
    assert torch.equal(moved.images, cast.images.permute(0, 1, 4, 2, 3))
    assert torch.equal(moved.labels, cast.labels)


def _val():
    val = SyntheticSegDataset(1, (256, 256), seed=9)
    return lambda: batch_iterator(val, 1, shuffle=False)


def _scalars(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("eval_every", [4, 3])
def test_fit_chunked_equals_per_step_bitwise(tmp_path, eval_every):
    """5 steps at unroll 2 (chunks [1, 2], [3, 4] and the tail [5]) against
    unroll 1: the same state bit for bit and the same logged metrics. The
    eval of step `eval_every` is logged under that step; at unroll 2 its
    checkpoint holds the state at the chunk's end, step 4."""
    runs = {}
    for unroll in (1, 2):
        cfg = _cfg(tmp_path / f"u{unroll}", unroll_steps=unroll, eval_every=eval_every,
                   log_path=str(tmp_path / f"u{unroll}" / "log"))
        trainer = KDTrainer(cfg)
        trainer.fit(_batches(5), _val(), eval_out_size=(256, 256))
        runs[unroll] = trainer
        rows = _scalars(tmp_path / f"u{unroll}" / "log" / "scalars.jsonl")
        assert [r["step"] for r in rows if "g_loss" in r] == [1, 2, 3, 4, 5]
        assert [r["step"] for r in rows if "val_mean_iu" in r] == [eval_every]
        (snapshot,) = (tmp_path / f"u{unroll}" / "snap").glob(f"CS_scenes_{eval_every}_*.pth")
        meta = ckpt.load_meta(str(snapshot))
        assert meta["step"] == eval_every
        assert meta["state_step"] == (eval_every if unroll == 1 else 4)
    _assert_same_run(runs[1], runs[2])
    assert runs[1].history == runs[2].history


def _sigterm_at(batches, i_kill):
    for i, b in enumerate(batches):
        if i == i_kill:
            os.kill(os.getpid(), signal.SIGTERM)
        yield b


def test_sigterm_at_a_chunk_boundary_then_resume_equals_unbroken(tmp_path):
    """The notice arrives while the first batch of chunk 2 is fetched: chunk 2
    finishes, the full state is saved at step 4, and a resumed run of the
    last 2 steps ends where an unbroken 6-step run does."""
    unbroken = KDTrainer(_cfg(tmp_path / "unbroken", unroll_steps=2))
    unbroken.fit(_batches(6))
    cfg = _cfg(tmp_path / "split", unroll_steps=2)
    first = KDTrainer(cfg)
    prev = signal.getsignal(signal.SIGTERM)
    first.fit(_sigterm_at(_batches(6), 2))
    assert signal.getsignal(signal.SIGTERM) == prev
    assert first.state.step == 4
    assert os.listdir(tmp_path / "split" / "snap" / "latest") == ["step_00000004.pth"]
    second = KDTrainer(cfg)
    assert second.try_resume() == 4
    _assert_same_run(first, second)
    second.fit(_batches(6)[4:])
    _assert_same_run(unbroken, second)


def test_profile_dir_writes_a_trace(tmp_path):
    """profile_steps=1 over 11 steps at unroll 2: the window [10, 11) starts
    before chunk [9, 10] and stops after it."""
    prof_dir = tmp_path / "prof"
    cfg = _cfg(tmp_path, unroll_steps=2, profile_dir=str(prof_dir), profile_steps=1)
    trainer = KDTrainer(cfg)
    trainer.fit(_batches(11))
    assert trainer.state.step == 11
    traces = list(prof_dir.glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert "student_loss_and_grad" in text and "d_loss_and_grad" in text
    assert cfg.profile_dir == str(prof_dir)


def test_config_rejects_unroll_below_one():
    with pytest.raises(ValueError, match="unroll_steps"):
        TrainConfig(unroll_steps=0)
