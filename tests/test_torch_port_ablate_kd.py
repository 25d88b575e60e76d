"""The KD ablation harness (`cli/ablate_kd.py`) against `scripts/ablate_kd.py`,
and the train step's skipped teacher forward.

  * The step runs no teacher forward when pi, pa and ho are all off (the JAX
    step's forward is dead code XLA drops): a teacher whose forward raises
    is never called, and the step's losses and updated state equal, bit for
    bit, those of the same step with a real teacher.
  * The harness keeps the JAX script's constants and palette (the script is
    loaded by path; its top level imports only numpy); its task generator
    (bilinear upsample, argmax, palette, noise) matches
    `jax.image.resize(..., "bilinear")` + argmax + palette on the same numpy
    fields and noise; its streams follow the JAX rules; each arm's config
    has the JAX `make_cfg` values, and one step of each arm at the
    ablation geometry (256², 6 classes, D 33/16, width 0.25, f32, dropout
    off), on the train-step test's two frames and on four of the harness's
    own, holds against the JAX `make_train_step` with the tolerances of
    tests/test_torch_port_train_step.py, and on two of the harness's own
    with the port's step in f64 (see `test_arm_step_matches_jax`); the
    harness runs end to end on the CPU, and a rerun on its state dir trains
    nothing.
"""

import contextlib
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import create_train_state
from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training import make_train_step as jax_make_train_step
from structure_knowledge_distillation_tpu_torch.cli import ablate_kd as ab
from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops import resize as tresize
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)
from test_torch_port_train_step import (
    LOSS_ATOL,
    LOSS_RTOL,
    STATE_LEAVES,
    _compare_state,
    _compare_updates,
    _numpy_sd,
    _randomized_vars,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 0.25
JAX_CFG_FIELDS = ("data_set", "classes_num", "batch_size", "input_size", "num_steps", "pi",
                  "pa", "ho", "lambda_pi", "lambda_pa", "lambda_d", "pool_scale",
                  "imsize_for_adv", "adv_conv_dim", "compute_dtype", "fused_ce")
# the fields the JAX script leaves at the JAX TrainConfig's defaults
JAX_DEFAULTS = ("lr_g", "lr_d", "momentum", "weight_decay", "power", "lambda_gp",
                "adv_loss_type", "preprocess_gan_mode", "ohem", "ohem_thresh", "ohem_min_kept",
                "student_arch")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """The suite runs in several worker processes on a few cores: torch's
    default of one thread per core in each of them oversubscribes the host
    (small steps then take many times longer), so these tests take two."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---- the step without a teacher forward


class _NoForward(torch.nn.Module):
    """A teacher slot whose forward must not run."""

    def forward(self, x):
        raise AssertionError("the step ran the teacher forward with pi, pa and ho off")


def _small_state(teacher_kind: str, cfg):
    """Seed-0 student and D (width 0.25, layers 1,1,1,1, 6 classes) with a
    real Bottleneck teacher or one whose forward raises."""
    g = torch.Generator().manual_seed(0)
    student = ResPSPNet(BASIC, ab.LAYERS, 6, width_mult=WIDTH, generator=g)
    disc = ab.make_discriminator(cfg, g)
    if teacher_kind == "real":
        teacher = ResPSPNet(BOTTLENECK, ab.LAYERS, 6, width_mult=WIDTH,
                            generator=torch.Generator().manual_seed(1))
        teacher.requires_grad_(False)
    else:
        teacher = _NoForward()
    return ab.make_state(cfg, teacher, student, disc)


def _run_small(teacher_kind: str, entry: str):
    """Two steps of the all-off config at 256², batch 2: through
    `make_train_step` or a `make_train_loop` chunk of two; the metrics and
    the student's and D's tensors with the momentum buffers after them."""
    cfg = ab.make_cfg(False, False, False, 8, "cpu", batch=2, unroll=2)
    state = _small_state(teacher_kind, cfg)
    palette = torch.from_numpy(ab._palette())
    images_k, labels_k = ab.gen_chunk(0, 0, 2, 2, palette)
    gen = torch.Generator().manual_seed(5)
    if entry == "step":
        step = make_train_step(cfg)
        metrics = [step(state, images_k[i], labels_k[i], gen) for i in range(2)]
        metrics = {k: torch.stack([m[k] for m in metrics]) for k in metrics[0]}
    else:
        metrics = make_train_loop(cfg, 2)(state, images_k, labels_k, 2, gen)
    tensors = {**{f"s.{k}": v for k, v in state.student.state_dict().items()},
               **{f"d.{k}": v for k, v in state.discriminator.state_dict().items()}}
    for name, opt in (("g", state.g_opt), ("d", state.d_opt)):
        for i, s in enumerate(opt.state.values()):
            tensors[f"{name}.momentum.{i}"] = s["momentum_buffer"]
    return metrics, tensors, state.step


@pytest.mark.parametrize("entry", ["step", "loop"])
def test_step_without_terms_runs_no_teacher_forward(entry):
    metrics, _, steps = _run_small("raises", entry)
    assert steps == 2
    assert set(metrics) == {"mc_loss", "g_loss", "d_loss"}
    assert torch.isfinite(metrics["g_loss"]).all()
    assert torch.equal(metrics["g_loss"], metrics["mc_loss"])


@pytest.mark.parametrize("entry", ["step", "loop"])
def test_step_without_terms_equals_step_with_real_teacher(entry):
    """The skipped forward changes nothing the step computes: losses and
    every updated tensor bit-equal to the same steps with a real teacher."""
    m_skip, t_skip, _ = _run_small("raises", entry)
    m_real, t_real, _ = _run_small("real", entry)
    assert set(m_skip) == set(m_real)
    for k in m_real:
        assert torch.equal(m_skip[k], m_real[k]), k
    assert set(t_skip) == set(t_real)
    for k in t_real:
        assert torch.equal(t_skip[k], t_real[k]), k


# ---- the harness against the JAX script


def _jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_ablate_kd_script", os.path.join(REPO, "scripts", "ablate_kd.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_constants_and_palette_match_the_jax_script():
    js = _jax_script()
    for name in ("SIZE", "CLASSES", "BATCH", "UNROLL", "FIELD_RES", "NOISE_SIGMA",
                 "VAL_IMAGES"):
        assert getattr(ab, name) == getattr(js, name), name
    np.testing.assert_array_equal(ab._palette(), js._palette())
    assert ab._palette().dtype == np.float32


@pytest.mark.parametrize("argv,want", [
    ([], dict(teacher_steps=1200, arm_steps=300, train_chunks=0, seeds=[0, 1],
              device="cuda")),
    (["--cpu"], dict(device="cpu")),
    (["--device", "cpu", "--teacher-steps", "1200", "--arm-steps", "1200",
      "--train-chunks", "2", "--seeds", "0,1,2,3,4"],
     dict(arm_steps=1200, train_chunks=2, seeds=[0, 1, 2, 3, 4], device="cpu")),
], ids=["defaults", "cpu", "finite-reuse"])
def test_cli_flags(monkeypatch, argv, want):
    """The JAX script's flags and defaults, `--cpu` as `--device cpu`, and
    `--device` defaulting to cuda; the out and state paths under the
    temporary directory by default."""
    seen = {}

    def fake(teacher_steps, arm_steps, train_chunks, seeds, out, state_dir, device):
        seen.update(teacher_steps=teacher_steps, arm_steps=arm_steps,
                    train_chunks=train_chunks, seeds=seeds, out=out, state_dir=state_dir,
                    device=device)
        return {}, []

    monkeypatch.setattr(ab, "ablate", fake)
    ab.main(argv)
    for k, v in want.items():
        assert seen[k] == v, (k, seen)
    assert seen["out"].endswith("ablate_kd.json")
    assert seen["state_dir"].endswith("ablate_kd_state")


@pytest.mark.parametrize("seed", [0, 1])
def test_generator_matches_jax_resize_argmax_palette(seed):
    """The same numpy fields and unit noise through `ab.render` and through
    the JAX script's `gen_batch` arithmetic: the upsampled fields within
    1e-5 (edges included), labels equal except at near-ties (≤ 1e-4 of the
    pixels), images within 1e-4 wherever the labels agree."""
    rng = np.random.RandomState(seed)
    b = 2
    fields = rng.randn(b, ab.FIELD_RES, ab.FIELD_RES, ab.CLASSES).astype(np.float32)
    noise = rng.randn(b, ab.SIZE, ab.SIZE, 3).astype(np.float32)
    palette = ab._palette()

    up_j = jax.image.resize(jnp.asarray(fields), (b, ab.SIZE, ab.SIZE, ab.CLASSES), "bilinear")
    labels_j = np.asarray(jnp.argmax(up_j, axis=-1).astype(jnp.int32))
    images_j = np.asarray(jnp.asarray(palette)[labels_j] + ab.NOISE_SIGMA * jnp.asarray(noise))

    up_t = F.interpolate(torch.from_numpy(fields).permute(0, 3, 1, 2), size=(ab.SIZE, ab.SIZE),
                         mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(up_t, np.asarray(up_j), rtol=0, atol=1e-5)
    for edge in (np.s_[:, 0], np.s_[:, -1], np.s_[:, :, 0], np.s_[:, :, -1]):
        np.testing.assert_allclose(up_t[edge], np.asarray(up_j)[edge], rtol=0, atol=1e-5)

    images, labels = ab.render(torch.from_numpy(fields), torch.from_numpy(noise),
                               torch.from_numpy(palette))
    assert images.shape == (b, 3, ab.SIZE, ab.SIZE) and images.dtype == torch.float32
    assert labels.shape == (b, ab.SIZE, ab.SIZE) and labels.dtype == torch.int32
    labels = labels.numpy()
    same = labels == labels_j
    assert 1.0 - same.mean() <= 1e-4, 1.0 - same.mean()
    images = images.permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(images[same], images_j[same], rtol=0, atol=1e-4)
    assert len(np.unique(labels)) == ab.CLASSES


def test_stream_rules():
    """The same (seed, chunk) gives the same bytes; another chunk or seed
    differs; val groups differ from every train chunk tried (seeds 0, 1 and
    the teacher's 999); `data_chunk` cycles a finite pool."""
    palette = torch.from_numpy(ab._palette())
    a = ab.gen_chunk(0, 3, 2, 2, palette)
    b = ab.gen_chunk(0, 3, 2, 2, palette)
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert a[0].shape == (2, 2, 3, ab.SIZE, ab.SIZE) and a[1].shape == (2, 2, ab.SIZE, ab.SIZE)
    assert not torch.equal(a[0], ab.gen_chunk(0, 4, 2, 2, palette)[0])
    assert not torch.equal(a[0], ab.gen_chunk(1, 3, 2, 2, palette)[0])
    trains = [ab.gen_chunk(s, c, 2, 2, palette)[0] for s in (0, 1, ab.TEACHER_SEED)
              for c in range(3)]
    for i in range(2):
        v, _ = ab.val_batch(i, 2, palette)
        assert all(not torch.equal(v, t[k]) for t in trains for k in range(2))
    seeds = {ab.data_seed(s, c) for s in (0, 1, 2, 3, 4, ab.TEACHER_SEED) for c in range(300)}
    assert len(seeds) == 6 * 300
    assert not seeds & {ab.val_seed(i) for i in range(1000)}
    assert [ab.data_chunk(c, 2) for c in range(5)] == [0, 1, 0, 1, 0]
    assert [ab.data_chunk(c, 0) for c in range(5)] == list(range(5))


class _SpyLoop:
    """A loop that records each chunk's images and trains nothing."""

    unroll, captures, eager_steps, replayed_steps, capture_ms = 2, 0, 0, 0, 0.0

    def __init__(self):
        self.chunks = []

    def __call__(self, state, images_k, labels_k, n_valid, generator):
        self.chunks.append(images_k.clone())
        return {"g_loss": torch.full((2,), float(len(self.chunks)))}


def test_train_cycles_the_finite_pool():
    """`train` with `train_chunks` 2 feeds chunks 0, 1, 0, 1, 0; with 0,
    five different chunks; and reports the first and last chunk's loss."""
    palette = torch.from_numpy(ab._palette())
    for tc, want in ((2, [0, 1, 0, 1, 0]), (0, [0, 1, 2, 3, 4])):
        loop = _SpyLoop()
        rec = ab.train(None, loop, None, 10, 0, palette, tc, batch=2)
        for got, c in zip(loop.chunks, want):
            assert torch.equal(got, ab.gen_chunk(0, c, 2, 2, palette)[0])
        assert rec["first_chunk_loss"] == 1.0 and rec["last_chunk_loss"] == 5.0
        assert rec["final_loss"] == 5.0 and rec["steps"] == 10


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("arm", ab.ARM_NAMES)
def test_arm_config_fields(arm, device):
    """`want` copies the JAX `make_cfg` values (scripts/ablate_kd.py:150-160;
    that `make_cfg` is a closure inside the script's `main()` and cannot be
    called); bf16 and the fused CE on the card, f32 and the materialised CE
    on the CPU. The JAX `TrainConfig` built from those values holds the
    fields the script leaves at their defaults (lr, momentum, power, weight
    decay, the GP and adversarial settings) against the port's."""
    flags = dict(ab.ARMS)[arm]
    cfg = ab.make_cfg(num_steps=300, device=device, **flags)
    want = dict(data_set="synthetic", classes_num=6, batch_size=8, input_size=(256, 256),
                num_steps=300, lambda_pi=10.0, lambda_pa=0.5, lambda_d=0.1, pool_scale=0.5,
                imsize_for_adv=33, adv_conv_dim=16, **flags,
                compute_dtype="bfloat16" if device == "cuda" else "float32",
                fused_ce="true" if device == "cuda" else "false")
    for k, v in want.items():
        assert getattr(cfg, k) == v, (k, getattr(cfg, k), v)
    assert cfg.unroll_steps == ab.UNROLL and cfg.device == device
    jcfg = JaxTrainConfig(**want)
    for f in JAX_DEFAULTS:
        assert getattr(cfg, f) == getattr(jcfg, f), (f, getattr(cfg, f), getattr(jcfg, f))


@pytest.fixture(scope="module")
def jax_start():
    return make_jax_start()


def make_jax_start():
    """Randomised JAX variables of the small teacher, student and D, shared
    by every case of the step parity test, and the "recipe" batch at the
    ablation geometry (256², 6 classes): tests/test_torch_port_train_step.py's
    two frames (unit normal, the second at 3× contrast and +1 brightness,
    random labels, 16 rows ignored), drawn first from the same stream."""
    rng = np.random.RandomState(42)
    images_nhwc = rng.randn(2, ab.SIZE, ab.SIZE, 3).astype(np.float32)
    images_nhwc[1] = 3.0 * images_nhwc[1] + 1.0
    labels = rng.randint(0, ab.CLASSES, (2, ab.SIZE, ab.SIZE)).astype(np.int32)
    labels[0, :16] = 255
    recipe = (torch.from_numpy(images_nhwc.transpose(0, 3, 1, 2).copy()),
              torch.from_numpy(labels))
    teacher = JaxResPSPNet(block="bottleneck", layers=ab.LAYERS, num_classes=ab.CLASSES,
                           drop_rate=0.0, width_mult=WIDTH)
    student = JaxResPSPNet(block="basic", layers=ab.LAYERS, num_classes=ab.CLASSES,
                           drop_rate=0.0, width_mult=WIDTH)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=16)
    key = jax.random.PRNGKey(0)
    x0 = jnp.zeros((1, 64, 64, 3), jnp.float32)  # the variables do not depend on the size
    # jitted: flax's op-by-op init takes several times longer on the CPU
    t_vars = _randomized_vars(rng, jax.jit(lambda k: teacher.init(k, x0, train=False))(key))
    s_vars = _randomized_vars(rng, jax.jit(lambda k: student.init(k, x0, train=False))(key))
    d0 = jnp.zeros((1, 33, 33, ab.CLASSES))
    d_vars = _randomized_vars(rng, jax.jit(lambda k: disc.init(k, d0, train=False))(key))
    return (teacher, student, disc), (t_vars, s_vars, d_vars), recipe


def _toy_batch(batch: int):
    """The harness's own first chunk of seed 0 at `batch`."""
    images, labels = ab.gen_chunk(0, 0, 1, batch, torch.from_numpy(ab._palette()))
    return images[0], labels[0]


def _worst_update_gap(jsd, before, after):
    """The largest ‖ΔJAX − Δport‖ / ‖Δport‖ over the updated tensors, and
    its tensor (the quantity `_compare_updates` holds under 2 %); (0.0,
    "nothing") where no tensor moved (D in the arms without ho)."""
    gaps = []
    for k in jsd:
        dt = after[k] - before[k]
        if k.endswith(STATE_LEAVES) or np.linalg.norm(dt) <= 1e-7:
            continue
        gaps.append((float(np.linalg.norm(jsd[k] - after[k]) / np.linalg.norm(dt)), k))
    return max(gaps, default=(0.0, "nothing"))


def _f64_interp(n_in: int, n_out: int) -> np.ndarray:
    """The align-corners operator of `ops/resize.py`, kept in f64."""
    a = np.zeros((n_out, n_in))
    if n_out == 1 or n_in == 1:
        a[:, 0] = 1.0
        return a
    src = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
    frac, rows = src - lo, np.arange(n_out)
    np.add.at(a, (rows, lo), 1.0 - frac)
    np.add.at(a, (rows, np.clip(lo + 1, 0, n_in - 1)), frac)
    return a


@contextlib.contextmanager
def _port_in_f64():
    """Inside, the port's step computes in f64: the places that compute in
    f32 on purpose (`Tensor.float`, the resize operators, tensors made at
    the default dtype) take f64 instead."""
    patches = ((torch.Tensor, "float", lambda self, *a, **k: self.to(torch.float64)),
               (tresize, "_operator",
                lambda n_in, n_out, device: torch.from_numpy(_f64_interp(n_in, n_out)).to(device)))
    saved = [(obj, name, getattr(obj, name)) for obj, name, _ in patches]
    dtype = torch.get_default_dtype()
    try:
        for obj, name, fn in patches:
            setattr(obj, name, fn)
        torch.set_default_dtype(torch.float64)
        yield
    finally:
        torch.set_default_dtype(dtype)
        for obj, name, fn in saved:
            setattr(obj, name, fn)


# Held apart in the "harness2" case: the D's input BatchNorm weight moves
# 3.2e-6 on weights of order 1, a few f32 spacings per element. Under input
# noise of 2^-22 (five draws; the f64 update stored in f32 did not move) the
# JAX f32 update of it lay 3.7-5.9 % from the port's f64 update stored in
# f32, and the port's own f32 update 0.0-4.6 % (tests/step_rounding_probe.py):
# both steps round it to a few percent, so it is held at 10 %, the other
# tensors at the 2 % envelope.
HARNESS2_BOUNDS = {("discriminator", "preprocess_additional.weight"): 0.10}


def arm_step(start, arm: str, images: torch.Tensor, labels: torch.Tensor, f64: bool = False):
    """One step of the arm's config through the harness's state and loop
    (unroll 1, the GP α the JAX step's own) and the JAX step on the same
    weights and batch: (JAX losses, port losses, (JAX student, JAX D) state
    dicts, the port's (student, D) before and after). With `f64` the port
    steps in f64 (`_port_in_f64`) and its new parameters are stored in f32,
    as the JAX step stores them."""
    (teacher, student, disc), (t_vars, s_vars, d_vars), _ = start
    batch = images.shape[0]
    cfg = ab.make_cfg(num_steps=300, device="cpu", batch=batch, unroll=1, **dict(ab.ARMS)[arm])
    jcfg = JaxTrainConfig(**{f: getattr(cfg, f) for f in JAX_CFG_FIELDS})
    g_tx = jax_make_sgd(jcfg.lr_g, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    d_tx = jax_make_sgd(jcfg.lr_d, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    state = create_train_state(jax.random.PRNGKey(7), t_vars, s_vars, d_vars, g_tx, d_tx)
    _, gp_rng = jax.random.split(jax.random.fold_in(state.rng, 0))
    alpha = torch.tensor(np.asarray(jax.random.uniform(gp_rng, (batch, 1, 1, 1), jnp.float32)))
    step_fn = jax.jit(jax_make_train_step(jcfg, teacher, student, disc, g_tx, d_tx))
    new, metrics = step_fn(state, jnp.asarray(images.permute(0, 2, 3, 1).numpy()),
                           jnp.asarray(labels.numpy()))
    jax_losses = {k: float(v) for k, v in metrics.items()}
    jax_sds = tuple({k: np.asarray(v) for k, v in sd.items()} for sd in (
        tckpt.state_dict_from_jax({"params": new.student_params,
                                   "batch_stats": new.student_stats}),
        tckpt.discriminator_state_dict_from_jax(
            {"params": new.d_params, "batch_stats": new.d_stats, "spectral": new.d_spectral})))

    g = torch.Generator().manual_seed(0)
    t_model = ResPSPNet(BOTTLENECK, ab.LAYERS, ab.CLASSES, width_mult=WIDTH, drop_rate=0.0)
    s_model = ResPSPNet(BASIC, ab.LAYERS, ab.CLASSES, width_mult=WIDTH, drop_rate=0.0)
    d_model = ab.make_discriminator(cfg, g)
    for model, sd in ((t_model, tckpt.state_dict_from_jax(t_vars)),
                      (s_model, tckpt.state_dict_from_jax(s_vars)),
                      (d_model, tckpt.discriminator_state_dict_from_jax(d_vars))):
        model.load_state_dict({k: torch.tensor(np.asarray(v)) for k, v in sd.items()},
                              strict=True)
    t_model.requires_grad_(False)
    before = (_numpy_sd(s_model), _numpy_sd(d_model))
    if f64:
        for model in (t_model, s_model, d_model):
            model.double()
        images, alpha = images.double(), alpha.double()
    pstate = ab.make_state(cfg, t_model, s_model, d_model)
    loop = make_train_loop(cfg, cfg.unroll_steps)
    with _port_in_f64() if f64 else contextlib.nullcontext():
        out = loop(pstate, images[None], labels[None], 1, g, alpha_k=alpha[None])
    assert pstate.step == 1
    port_losses = {k: float(v[0]) for k, v in out.items()}
    after = tuple({k: v.astype(np.float32) for k, v in _numpy_sd(m).items()}
                  for m in (s_model, d_model))
    return jax_losses, port_losses, jax_sds, before, after


@pytest.mark.parametrize("data", ["recipe", "toy", "harness2"])
@pytest.mark.parametrize("arm", ab.ARM_NAMES)
def test_arm_step_matches_jax(jax_start, arm, data):
    """One step of the arm's config through the harness's state and loop
    (unroll 1, the GP α the JAX step's own) against the JAX step on the
    same weights and batch, with the tolerances of
    tests/test_torch_port_train_step.py. Three batches: the train-step
    test's two frames ("recipe"), four of the harness's own (seed 0's first
    chunk at batch 4, "toy"), and two of them ("harness2", `_toy_batch(2)`).

    At batch 2 on the harness's frames the two f32 steps differ by more than
    the 2 % envelope (5.9 % on the D's input BN weight, pi+pa+ho), and an
    f64 run of the port settles why: each f32 step rounds. Against the
    port's f64 update the JAX f32 one lies at most 0.4 % away (student) and
    the port's f32 one 1.0 %; perturbing the input by 2^-22 moves each f32
    step's distance to the f64 update by as much as the two steps differ,
    while the f64 update, stored in f32, does not move (the numbers:
    tests/step_rounding_probe.py). So "harness2" runs the port's
    step in f64 (`_port_in_f64`), stores its new parameters in f32 as the
    JAX step does, and holds the JAX f32 step against it: the 2 % envelope
    for every tensor but the one in `HARNESS2_BOUNDS`. Each case prints its
    worst update gap (run with -s to read it)."""
    images, labels = {"recipe": lambda: jax_start[2], "toy": lambda: _toy_batch(4),
                      "harness2": lambda: _toy_batch(2)}[data]()
    f64 = data == "harness2"
    jax_losses, port_losses, jax_sds, before, after = arm_step(jax_start, arm, images, labels,
                                                               f64)
    assert sorted(port_losses) == sorted(jax_losses)
    for k, v in jax_losses.items():
        np.testing.assert_allclose(port_losses[k], v, rtol=LOSS_RTOL[0], atol=LOSS_ATOL[0],
                                   err_msg=f"{arm}:{k}")
    for i, label in enumerate(("student", "discriminator")):
        jsd = jax_sds[i]
        print(f"{arm}/{data} {label}: worst update gap %.4f at %s"
              % _worst_update_gap(jsd, before[i], after[i]))
        apart = {k: b for (lb, k), b in HARNESS2_BOUNDS.items() if f64 and lb == label}
        _compare_updates({k: v for k, v in jsd.items() if k not in apart}, before[i], after[i],
                         1, f"{arm}:{label}")
        for k, bound in apart.items():
            dj, dt = jsd[k] - before[i][k], after[i][k] - before[i][k]
            if np.linalg.norm(dt) > 1e-7:
                gap = np.linalg.norm(dj - dt) / np.linalg.norm(dt)
                assert gap < bound, (arm, label, k, gap)
        _compare_state(jsd, after[i], f"{arm}:{label}")


def test_harness_end_to_end_and_resume(tmp_path, monkeypatch, capsys):
    """Batch 2, unroll 2, 4 val frames, 2 teacher and 2 arm steps, seed 0 on
    the CPU: the JSON has exactly the JAX artifact's keys plus `device`,
    finite losses and mIoUs in [0, 1]; a rerun on the same state dir trains
    no step (its loop constructor raises) and returns equal results (the
    wall aside)."""
    kw = dict(teacher_steps=2, arm_steps=2, train_chunks=0, seeds=[0],
              state_dir=str(tmp_path / "state"), device="cpu", batch=2, unroll=2,
              val_images=4)
    res, legs = ab.ablate(out=str(tmp_path / "a.json"), **kw)
    with open(os.path.join(REPO, "artifacts", "ablation", "ablate_kd_a1200_tc2.json")) as f:
        ref = json.load(f)
    with open(tmp_path / "a.json") as f:
        written = json.load(f)
    assert written == json.loads(json.dumps(res))
    assert set(written) == set(ref) | {"device"}
    assert set(written["task"]) == set(ref["task"])
    assert set(written["teacher"]) == set(ref["teacher"])
    assert list(written["arms"]) == list(ref["arms"])
    for name, arm in written["arms"].items():
        assert set(arm) == set(ref["arms"][name])
        assert len(arm["val_mean_iu"]) == 1 and arm["spread"] == 0.0
        assert all(0.0 <= m <= 1.0 for m in arm["val_mean_iu"])
        assert all(np.isfinite(arm["final_loss"]))
    assert written["backend"] == "cpu" and written["device"] == "cpu"
    assert [leg["leg"] for leg in legs] == ["teacher", "none/s0", "pi/s0", "pi+pa/s0",
                                            "pi+pa+ho/s0"]
    assert all(leg["steps"] == 2 for leg in legs)
    names = sorted(os.listdir(tmp_path / "state"))
    assert names == sorted(["teacher_cpu_s2.pt", "teacher_cpu_s2.json"]
                           + [f"arm_{n}_0_cpu_s2_a2.json" for n in ab.ARM_NAMES])

    def no_loop(*a, **k):
        raise AssertionError("a rerun trained a leg")

    monkeypatch.setattr(ab, "make_train_loop", no_loop)
    capsys.readouterr()
    res2, legs2 = ab.ablate(out=str(tmp_path / "b.json"), **kw)
    assert legs2 == []
    assert "resumed" in capsys.readouterr().out
    with open(tmp_path / "b.json") as f:
        written2 = json.load(f)
    written.pop("wall_s"), written2.pop("wall_s")
    assert written2 == written
