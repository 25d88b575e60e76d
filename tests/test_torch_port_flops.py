"""The FLOP counter (`utils/flops.py::flops_of_fn`) against the JAX one.

Each case counts the same function of both packages on the same shapes, the
port on fake tensors (`FakeTensorMode`, nothing computed), JAX from its jaxpr
(`make_jaxpr`, nothing computed), with the JAX `fused_ce` "false" and
`bn_fused` off, and holds

    port count == JAX count − Σ named terms

to 1e-9 relative. Each named term is a place where the packages count the
same function differently, computed here from the shapes (see the port
module's docstring):
  * `pool`: the JAX PSP pools through two `avg_pool_matrix` dots a bin
    (forward, and the same again backward); the port's pool counts 0;
  * `psp`: the JAX PSP bottleneck is the factored `_PSPBottleneckConv`
    (each prior's 512×512 channel mix at k×k, then its upsample folded into
    the conv taps); the port upsamples each prior (two matmuls) and runs the
    dense 3×3 conv over the concat;
  * `dgrad`: JAX counts a convolution's data-gradient at the input's
    positions over the stride's product, torch at the forward's output
    positions: they differ where an input side is not stride × the output
    side (65 → 33 at stride 2, the D's 33 → 16, its VALID 4 → 1 head);
  * `gp_wgrad` and `gp_ggo`: the WGAN-GP's second derivative through a
    convolution. JAX counts the weight cotangent of the first backward's
    data-gradient like that data-gradient; torch's double backward computes
    it as a convolution over the whole padded input (5 × 5 for the D's
    first 4 × 4 kernel, narrowed to 4 × 4 after) and also the cotangent of
    the D head's incoming gradient, a constant nothing reads;
  * `sn`: the JAX spectral norm's power iteration and σ are dots; the
    port's are matrix-vector products (`mv`, `dot`), which count 0;
  * `s2d`: `bench.py` builds its models with the space-to-depth stem, a
    2 × 2 convolution over 12 channels where the port has the 3 × 3 one.

The JAX step at `tests/test_flops.py::test_kd_train_step_flops_scale`'s 64²
has a D of image size 9, whose VALID 4 × 4 head sees a 1 × 1 map (JAX makes
its output 0 × 0, torch refuses): the step case runs at 256², the smallest
crop whose D geometry closes (D 33), with the rest of that config.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import pytest
import torch
import torch.nn.functional as F
from torch._subclasses import FakeTensorMode
from torch.utils.checkpoint import checkpoint

from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import create_train_state
from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training import make_train_step as jax_make_train_step
from structure_knowledge_distillation_tpu.utils.flops import flops_of_fn as jax_flops
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step
from structure_knowledge_distillation_tpu_torch.utils.flops import flops_of_fn

CLASSES = 19
BINS = (1, 2, 3, 6)
KEY = jax.random.PRNGKey(0)


def _zeros(tree):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)


def _check(jax_count: float, port_count: float, terms: dict[str, float]) -> None:
    want = jax_count - sum(terms.values())
    print(f"jax {jax_count:.0f} port {port_count:.0f} terms {terms}")
    assert abs(port_count - want) <= 1e-9 * want, (jax_count, port_count, terms)


# ---- the named terms (JAX count − port count), from the shapes


def pool(n: int, c: int, h: int, w: int, passes: int) -> float:
    """The JAX pool's two dots a bin, `passes` times (1 forward, 2 with its
    backward), over an (n, c, h, w) input."""
    return passes * sum(2.0 * n * c * (s * h * w + s * s * w) for s in BINS)


def psp(n: int, h: int, w: int, c_stage: int, f: int, backward: bool) -> float:
    """Factored minus dense PSP bottleneck, the prior upsamples included,
    for priors of c_stage channels and f output channels."""
    total = 0.0
    for k in BINS:
        mix = 2.0 * n * k * k * c_stage * 9 * f            # bhwc,uvcd->buvhwd
        rows = 18.0 * n * h * k * k * f                     # uHh,buvhwd->bvHwd
        cols = 6.0 * n * h * w * k * f                      # vWw,bvHwd->bHWd
        resize = 2.0 * n * c_stage * (h * k * k + h * w * k)
        conv = 18.0 * n * h * w * f * c_stage               # the dense conv's share
        total += mix + rows + cols - resize - conv
        if backward:  # cotangents of the prior and the kernel; of the upsample's input
            total += 2 * mix + rows + cols - resize - 2 * conv
    return total


def dgrad(n, c_in, c_out, k, h_in, h_out, stride, times=1) -> float:
    """A (square) convolution's data-gradient, `times` times."""
    return times * 2.0 * n * c_in * c_out * k * k * (h_in * h_in / stride ** 2 - h_out * h_out)


def gp_wgrad(n, c_in, c_out, k, h_in, h_out, stride, pad) -> float:
    """The weight cotangent of the first backward's data-gradient in the GP's
    second derivative; torch's covers (h_in + 2·pad − (h_out − 1)·stride)²
    kernel positions."""
    g = h_in + 2 * pad - (h_out - 1) * stride
    return 2.0 * n * c_in * c_out * (k * k * h_in * h_in / stride ** 2 - h_out * h_out * g * g)


def _d_convs(image_size: int, conv_dim: int) -> list[tuple]:
    """(c_in, c_out, h_in, h_out) of the D's spectral-norm convs (4 × 4,
    stride 2, pad 1)."""
    convs, c_in, h = [], CLASSES, image_size
    for c_out in (conv_dim, 2 * conv_dim, 4 * conv_dim) + ((8 * conv_dim,) if image_size == 65
                                                             else ()):
        convs.append((c_in, c_out, h, h // 2))
        c_in, h = c_out, h // 2
    return convs


def sn(image_size: int, conv_dim: int, applications: int, with_grad: int) -> float:
    """The JAX power iteration and σ: three (c_out × 16·c_in) matrix-vector
    dots and a c_out dot an application, and the outer product and scalar
    dot of σ's cotangent where the D's weights take a gradient."""
    total = 0.0
    for c_in, c_out, _, _ in _d_convs(image_size, conv_dim):
        kk = 16 * c_in
        total += applications * (6.0 * c_out * kk + 2 * c_out)
        total += with_grad * (2.0 * c_out * kk + 2 * c_out)
    return total


def d_terms(n: int, image_size: int, conv_dim: int) -> dict[str, float]:
    """A wgan-gp step's D terms: four D applications (G's adversarial term,
    D(T), D(S), the GP interpolate), three with weight gradients. The first
    conv takes five data-gradients (those four and the GP's pass back through
    the interpolate's forward), the VALID head four (the GP reads no score)."""
    convs = _d_convs(image_size, conv_dim)
    width = convs[-1][1]
    terms = {"sn": sn(image_size, conv_dim, 4, 3), "dgrad": 0.0, "gp_wgrad": 0.0}
    for c_in, c_out, h_in, h_out in convs:
        terms["dgrad"] += dgrad(n, c_in, c_out, 4, h_in, h_out, 2, times=5)
        terms["gp_wgrad"] += gp_wgrad(n, c_in, c_out, 4, h_in, h_out, 2, 1)
    terms["dgrad"] += dgrad(n, width, 1, 4, 4, 1, 1, times=4)
    terms["gp_wgrad"] += gp_wgrad(n, width, 1, 4, 4, 1, 1, 0)
    terms["gp_ggo"] = -2.0 * n * width * 16
    return terms


# ---- toy cases (tests/test_flops.py)


def test_matmul():
    _check(jax_flops(lambda a, b: a @ b, jnp.zeros((32, 64)), jnp.zeros((64, 16))),
           flops_of_fn(lambda a, b: a @ b, torch.zeros(32, 64), torch.zeros(64, 16)), {})


def test_batched_einsum():
    jfn = lambda a, b: jax.lax.dot_general(a, b, (((2,), (1,)), ((0,), (0,))))  # noqa: E731
    _check(jax_flops(jfn, jnp.zeros((4, 8, 16)), jnp.zeros((4, 16, 5))),
           flops_of_fn(lambda a, b: torch.einsum("bij,bjk->bik", a, b),
                       torch.zeros(4, 8, 16), torch.zeros(4, 16, 5)), {})


def _jconv(stride):
    return lambda x, k: jax.lax.conv_general_dilated(
        x, k, (stride, stride), "SAME", dimension_numbers=("NHWC", "HWIO", "NHWC"))


def test_conv3x3():
    _check(jax_flops(_jconv(1), jnp.zeros((2, 16, 16, 8)), jnp.zeros((3, 3, 8, 4))),
           flops_of_fn(lambda x, w: F.conv2d(x, w, padding=1),
                       torch.zeros(2, 8, 16, 16), torch.zeros(4, 8, 3, 3)), {})


@pytest.mark.parametrize("size", [16, 17])
def test_strided_conv_with_its_gradient(size):
    """Forward, data- and weight-gradient; at 17² the data-gradient's
    convention differs (17²/4 against 9² positions)."""
    def port(x, w):
        x.requires_grad_(True)
        w.requires_grad_(True)
        F.conv2d(x, w, stride=2, padding=1).sum().backward()

    conv = _jconv(2)
    jfn = lambda x, k: jax.grad(lambda x, k: conv(x, k).sum(), argnums=(0, 1))(x, k)  # noqa: E731
    out = -(-size // 2)
    _check(jax_flops(jfn, jnp.zeros((1, size, size, 8)), jnp.zeros((3, 3, 8, 4))),
           flops_of_fn(port, torch.zeros(1, 8, size, size), torch.zeros(4, 8, 3, 3)),
           {"dgrad": dgrad(1, 8, 4, 3, size, out, 2)})


def test_remat_function():
    def port(a):
        a.requires_grad_(True)
        checkpoint(lambda t: (t @ t).sum(), a, use_reentrant=False).backward()

    rem = jax.checkpoint(lambda a: (a @ a).sum())
    _check(jax_flops(lambda a: jax.value_and_grad(rem)(a), jnp.zeros((8, 8))),
           flops_of_fn(port, torch.zeros(8, 8)), {})


# ---- the models' forwards and the whole step


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_model_forward(block):
    jmodel = JaxResPSPNet(block=block, layers=(1, 1, 1, 1), num_classes=CLASSES)
    images = jnp.zeros((2, 64, 64, 3))
    variables = _zeros(jax.eval_shape(lambda: jmodel.init(KEY, images[:1], train=False)))
    want = jax_flops(lambda v, x: jmodel.apply(v, x, train=False)[0], variables, images)
    with FakeTensorMode():
        model = ResPSPNet(block, (1, 1, 1, 1), CLASSES).eval()
        with torch.no_grad():
            got = flops_of_fn(model, torch.zeros(2, 3, 64, 64))
    c4, f = (512, 128) if block == "basic" else (2048, 512)
    _check(want, got, {"pool": pool(2, c4, 9, 9, 1), "psp": psp(2, 9, 9, f, f, False)})


def test_discriminator_forward():
    jdisc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=8)
    x = jnp.zeros((2, 33, 33, CLASSES))
    variables = _zeros(jax.eval_shape(lambda: jdisc.init(KEY, x[:1], train=False)))
    want = jax_flops(lambda v, x: jdisc.apply(v, x, train=False), variables, x)
    with FakeTensorMode():
        disc = Discriminator(CLASSES, 1, 33, 8).eval()
        with torch.no_grad():
            got = flops_of_fn(disc, torch.zeros(2, CLASSES, 33, 33))
    _check(want, got, {"sn": sn(33, 8, 1, 0)})


def _jax_step_flops(n, size, teacher_layers, student_layers, d_size, d_dim, dtype, stem_s2d):
    cfg = JaxTrainConfig(classes_num=CLASSES, batch_size=n, input_size=(size, size),
                         num_steps=10, imsize_for_adv=d_size, fused_ce="false",
                         compute_dtype="float32" if dtype is None else "bfloat16")
    teacher = JaxResPSPNet(block="bottleneck", layers=teacher_layers, num_classes=CLASSES,
                           dtype=dtype, stem_s2d=stem_s2d)
    student = JaxResPSPNet(block="basic", layers=student_layers, num_classes=CLASSES,
                           dtype=dtype, stem_s2d=stem_s2d)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=d_size, conv_dim=d_dim, dtype=dtype)
    images = jnp.zeros((n, size, size, 3))
    labels = jnp.zeros((n, size, size), jnp.int32)
    t_vars = _zeros(jax.eval_shape(lambda: teacher.init(KEY, images[:1], train=False)))
    s_vars = _zeros(jax.eval_shape(lambda: student.init(KEY, images[:1], train=False)))
    d_vars = _zeros(jax.eval_shape(
        lambda: disc.init(KEY, jnp.zeros((1, d_size, d_size, CLASSES)), train=False)))
    g_tx = jax_make_sgd(0.01, 10, 0.9, 0.9, 5e-4)
    d_tx = jax_make_sgd(0.01, 10, 0.9, 0.9, 5e-4)
    state = create_train_state(KEY, t_vars, s_vars, d_vars, g_tx, d_tx)
    step = jax_make_train_step(cfg, teacher, student, disc, g_tx, d_tx)
    return jax_flops(step, state, images, labels)


def port_step_flops(n, size, teacher_layers, student_layers, d_size, d_dim, dtype,
                    fused_ce="false") -> float:
    """The port's train step (Pi+Pa+Ho, wgan-gp) counted on fake CPU tensors."""
    cfg = TrainConfig(classes_num=CLASSES, batch_size=n, input_size=(size, size), num_steps=10,
                      imsize_for_adv=d_size, adv_conv_dim=d_dim, fused_ce=fused_ce,
                      compute_dtype="float32" if dtype is None else "bfloat16", device="cpu")
    with FakeTensorMode():
        teacher = ResPSPNet("bottleneck", teacher_layers, CLASSES, dtype=dtype)
        student = ResPSPNet("basic", student_layers, CLASSES, dtype=dtype)
        disc = Discriminator(CLASSES, 1, d_size, d_dim, dtype=dtype)
        teacher.requires_grad_(False)
        state = KDTrainState(
            teacher=teacher, student=student, discriminator=disc,
            g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
            d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
            g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
            d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))
        return flops_of_fn(make_train_step(cfg), state, torch.zeros(n, 3, size, size),
                           torch.zeros(n, size, size, dtype=torch.int32),
                           torch.Generator().manual_seed(0))


def step_terms(n, size, d_size, d_dim, stem_s2d) -> dict[str, float]:
    """Every named term of one Pi+Pa+Ho wgan-gp step: the teacher's forward,
    the student's forward and backward (its stride-2 layer2.0 conv1 and
    downsample take a data-gradient each), and the D's."""
    h1, h8 = -(-size // 4) + 1, -(-size // 8) + 1  # after the ceil pool; stride 8
    terms = d_terms(n, d_size, d_dim)
    terms["pool"] = pool(n, 2048, h8, h8, 1) + pool(n, 512, h8, h8, 2)
    terms["psp"] = psp(n, h8, h8, 512, 512, False) + psp(n, h8, h8, 128, 128, True)
    terms["dgrad"] += (dgrad(n, 64, 128, 3, h1, h8, 2) + dgrad(n, 64, 128, 1, h1, h8, 2))
    if stem_s2d:  # teacher forward, student forward and weight gradient
        terms["s2d"] = 3 * 2.0 * n * (size // 2) ** 2 * 64 * (12 * 4 - 3 * 9)
    return terms


def test_kd_train_step():
    """The whole Pi+Pa+Ho wgan-gp step: batch 2, 256², 19 classes, layers
    (1,1,1,1), D 33/8, f32."""
    want = _jax_step_flops(2, 256, (1, 1, 1, 1), (1, 1, 1, 1), 33, 8, None, False)
    got = port_step_flops(2, 256, (1, 1, 1, 1), (1, 1, 1, 1), 33, 8, None)
    _check(want, got, step_terms(2, 256, 33, 8, False))


def test_bench_config_step():
    """`bench.py`'s step: batch 8, 512², bf16, R101 teacher, R18 student,
    D 65/64, Pi+Pa+Ho, wgan-gp, the JAX models with `bench.py`'s
    space-to-depth stem."""
    want = _jax_step_flops(8, 512, (3, 4, 23, 3), (2, 2, 2, 2), 65, 64, jnp.bfloat16, True)
    got = port_step_flops(8, 512, (3, 4, 23, 3), (2, 2, 2, 2), 65, 64, torch.bfloat16)
    _check(want, got, step_terms(8, 512, 65, 64, True))


def test_fake_count_equals_a_real_one_and_leaves_no_fake_tables():
    """The count of a real call equals the fake one; a fake count caches no
    fake tensor (the resize and pooling tables), so a real forward after it
    runs."""
    model = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25).eval()
    x = torch.randn(1, 3, 64, 64)
    with torch.no_grad():
        real = flops_of_fn(model, x)
    with FakeTensorMode():
        fake_model = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25).eval()
        with torch.no_grad():
            fake = flops_of_fn(fake_model, torch.zeros(1, 3, 64, 64))
        train = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25).train()
        out = train(torch.zeros(2, 3, 96, 96), draws=lambda s: torch.rand(s))
        (out[0].sum() + out[1].sum()).backward()
    assert real == fake > 0
    with torch.no_grad():
        assert torch.isfinite(model(x)[0]).all()
    y = torch.randn(2, 3, 96, 96, requires_grad=True)
    out = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25).train()(y)
    (out[0].sum() + out[1].sum()).backward()
    assert torch.isfinite(y.grad).all()
