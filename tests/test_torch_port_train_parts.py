"""The port's train-path parts vs the JAX package, on the CPU.

Train-mode ABN and BatchNorm2d (including the double backward the WGAN-GP
takes through the discriminator), the Pa max-pool gradient on tied inputs,
spectral-norm convs, the SAGAN discriminator in its three preprocess modes
and both geometries, and the Pi, Pa, adversarial and gradient-penalty
losses: same numpy inputs, same weights (crossed over with
`discriminator_state_dict_from_jax`), values and gradients compared.

Tolerances: everything is f32 on both sides. Single reductions agree to
rtol 1e-5 / atol 1e-6; the discriminator, four convs and two attention
layers deep, to rtol 1e-4 / atol 1e-5 (different conv and matmul summation
orders); gradients through it, and second derivatives, to 1e-4 of their
largest entry. Per-parameter discriminator gradients get 2e-4 of their own
largest entry plus 1e-6 of the largest over all of D: the key-conv bias has
an analytically zero gradient (a softmax does not see a per-row shift), so
only rounding noise is left there to compare.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu.losses import adversarial as jadv
from structure_knowledge_distillation_tpu.losses import distill as jdistill
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.ops import batch_norm as jbn
from structure_knowledge_distillation_tpu.ops.pooling import max_pool_2d as jax_max_pool
from structure_knowledge_distillation_tpu.ops.spectral import SNConv as JaxSNConv
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu_torch import losses as tlosses
from structure_knowledge_distillation_tpu_torch.models import Discriminator
from structure_knowledge_distillation_tpu_torch.ops import batch_norm as tbn
from structure_knowledge_distillation_tpu_torch.ops.spectral import SNConv
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

CLASSES = 7
CONV_DIM = 16


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a).transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _close_params(module, grads_ref):
    """Each parameter's gradient against the JAX one (see the module note).
    A parameter that autograd never reached (the last bias under the GP) has
    a zero gradient on the JAX side."""
    top = max(np.abs(g).max() for g in grads_ref.values())
    for name, p in module.named_parameters():
        ref = grads_ref[name]
        ours = p.grad.numpy() if p.grad is not None else np.zeros_like(ref)
        np.testing.assert_allclose(ours, ref, rtol=0,
                                   atol=2e-4 * np.abs(ref).max() + 1e-6 * top, err_msg=name)


def _close_rel(ours, ref, rel=1e-4, name=""):
    ref = np.asarray(ref)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * max(np.abs(ref).max(), 1e-30),
                               err_msg=name)


# ---------------------------------------------------------------- ABN train
@pytest.mark.parametrize("activation", ["none", "leaky_relu", "elu"])
def test_abn_train_matches_jax(activation):
    rng = np.random.RandomState(0)
    c = 5
    x = (rng.randn(3, 6, 7, c) * 2 + 0.5).astype(np.float32)
    weight = rng.randn(c).astype(np.float32)  # signed: |w| + eps matters
    bias = (0.3 * rng.randn(c)).astype(np.float32)
    mean0, var0 = (0.1 * rng.randn(c)).astype(np.float32), (rng.rand(c) + 0.5).astype(np.float32)
    cot = rng.randn(*x.shape).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    mod = jbn.ABN(activation=activation)

    def f(x, params):
        z, mut = mod.apply({"params": params, "batch_stats": variables["batch_stats"]}, x,
                           use_running_average=False, mutable=["batch_stats"])
        return jnp.sum(z * cot), (z, mut)

    (_, (z_ref, mut)), (gx, gp) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        jnp.asarray(x), variables["params"])

    tmod = tbn.ABN(c, activation=activation)
    tmod.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    tmod.train()
    tx = _nchw(x).requires_grad_()
    z = tmod(tx)
    (z * _nchw(cot)).sum().backward()
    np.testing.assert_allclose(_nhwc(z), np.asarray(z_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    _close_rel(_nhwc(tx.grad), gx, name="dx")
    _close_rel(tmod.weight.grad.numpy(), gp["weight"], name="dweight")
    _close_rel(tmod.bias.grad.numpy(), gp["bias"], name="dbias")


def test_batch_norm_2d_double_backward_matches_jax():
    """d/d(x, w, b) of ‖∂/∂x Σ BN(x)·r‖²: the WGAN-GP differentiates the
    analytic backward again."""
    rng = np.random.RandomState(1)
    c = 4
    x = rng.randn(2, 5, 5, c).astype(np.float32)
    r = rng.randn(*x.shape).astype(np.float32) ** 2  # non-linear weights keep the norm x-dependent
    weight, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    stats = {"mean": jnp.zeros(c), "var": jnp.ones(c)}
    mod = jbn.BatchNorm2d()

    def h(x, params):
        def f(x):
            z, _ = mod.apply({"params": params, "batch_stats": stats}, x,
                             use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(jnp.tanh(z) * r)
        g = jax.grad(f)(x)
        return jnp.sum(g * g)

    params = {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)}
    ref, (hx, hp) = jax.value_and_grad(h, argnums=(0, 1))(jnp.asarray(x), params)

    tmod = tbn.BatchNorm2d(c)
    with torch.no_grad():
        tmod.weight.copy_(torch.from_numpy(weight))
        tmod.bias.copy_(torch.from_numpy(bias))
    tmod.train()
    tx = _nchw(x).requires_grad_()
    (g,) = torch.autograd.grad((torch.tanh(tmod(tx)) * _nchw(r)).sum(), tx, create_graph=True)
    out = (g * g).sum()
    out.backward()
    np.testing.assert_allclose(out.item(), float(ref), rtol=1e-4)
    _close_rel(_nhwc(tx.grad), hx, name="d2x")
    _close_rel(tmod.weight.grad.numpy(), hp["weight"], name="d2weight")
    _close_rel(tmod.bias.grad.numpy(), hp["bias"], name="d2bias")


# ------------------------------------------------------------------ pooling
def test_pa_max_pool_gradient_on_tied_inputs_matches_jax():
    """The Pa pool (k = s = 32, ceil, 65² → 3²) on a coarse grid full of
    ties: the gradient goes to the first maximum of each window in
    row-major order on both sides."""
    rng = np.random.RandomState(2)
    x = np.round(rng.rand(2, 65, 65, 3) * 2).astype(np.float32)  # values in {0, 1, 2}
    cot = rng.randn(2, 3, 3, 3).astype(np.float32)
    pool = lambda t: jax_max_pool(t, (32, 32), (32, 32), (0, 0), ceil_mode=True)  # noqa: E731
    y_ref, vjp = jax.vjp(pool, jnp.asarray(x))
    (g_ref,) = vjp(jnp.asarray(cot))
    tx = _nchw(x).requires_grad_()
    y = F.max_pool2d(tx, (32, 32), (32, 32), ceil_mode=True)
    (y * _nchw(cot)).sum().backward()
    np.testing.assert_array_equal(_nhwc(y), np.asarray(y_ref))
    np.testing.assert_array_equal(_nhwc(tx.grad), np.asarray(g_ref))


# ----------------------------------------------------------------- spectral
def test_snconv_matches_jax_after_one_application():
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 9, 4).astype(np.float32)
    mod = JaxSNConv(6)
    variables = mod.init(jax.random.PRNGKey(0), jnp.asarray(x), update_stats=False)
    variables = {"params": {"weight": jnp.asarray(rng.randn(4, 4, 4, 6).astype(np.float32)),
                            "bias": jnp.asarray(rng.randn(6).astype(np.float32))},
                 "spectral": variables["spectral"]}

    def f(params):
        y, mut = mod.apply({"params": params, "spectral": variables["spectral"]},
                           jnp.asarray(x), update_stats=True, mutable=["spectral"])
        return jnp.sum(y ** 2), (y, mut)

    (_, (y_ref, mut)), gp = jax.value_and_grad(f, has_aux=True)(variables["params"])

    ours = SNConv(4, 6)
    sd = {"module.weight_bar": np.transpose(np.asarray(variables["params"]["weight"]),
                                            (3, 2, 0, 1)),
          "module.bias": np.asarray(variables["params"]["bias"]),
          "module.weight_u": np.asarray(variables["spectral"]["u"]),
          "module.weight_v": np.asarray(variables["spectral"]["v"])}
    ours.load_state_dict({k: torch.tensor(v) for k, v in sd.items()})
    ours.train()
    y = ours(_nchw(x))
    (y ** 2).sum().backward()
    np.testing.assert_allclose(_nhwc(y), np.asarray(y_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ours.module.weight_u.numpy(), np.asarray(mut["spectral"]["u"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(ours.module.weight_v.numpy(), np.asarray(mut["spectral"]["v"]),
                               rtol=1e-5, atol=1e-6)
    _close_rel(ours.module.weight_bar.grad.numpy(),
               np.transpose(np.asarray(gp["weight"]), (3, 2, 0, 1)), name="dW (through σ)")
    ours.eval()  # eval mode iterates but keeps u/v
    u_before = ours.module.weight_u.clone()
    ours(_nchw(x))
    assert torch.equal(ours.module.weight_u, u_before)


# ------------------------------------------------------------ discriminator
def _randomized_d_vars(template, rng):
    """Signed BN weights, non-zero attention gammas, random running stats and
    unit u/v, so that every term of the forward is live."""
    def param(path, a):
        a = np.asarray(a)
        name = path[-1].key
        if name == "gamma":
            return jnp.asarray((0.5 + rng.rand(*a.shape)).astype(np.float32))
        if a.ndim == 1 and name == "weight":
            return jnp.asarray(rng.randn(*a.shape).astype(np.float32))
        if a.ndim == 1:
            return jnp.asarray((0.1 * rng.randn(*a.shape)).astype(np.float32))
        return jnp.asarray(a)

    out = {"params": jax.tree_util.tree_map_with_path(param, template["params"])}
    if "batch_stats" in template:
        out["batch_stats"] = {"preprocess_bn": {
            "mean": jnp.asarray((0.1 * rng.randn(CLASSES)).astype(np.float32)),
            "var": jnp.asarray((0.5 + rng.rand(CLASSES)).astype(np.float32))}}
    out["spectral"] = jax.tree.map(
        lambda a: jnp.asarray((lambda v: v / np.linalg.norm(v))(
            rng.randn(*a.shape).astype(np.float32))), template["spectral"])
    return out


def _d_pair(mode, size, seed):
    rng = np.random.RandomState(seed)
    jd = JaxDiscriminator(preprocess_mode=mode, image_size=size, conv_dim=CONV_DIM)
    x0 = jnp.zeros((1, size, size, CLASSES))
    variables = _randomized_d_vars(jd.init(jax.random.PRNGKey(seed), x0, train=False), rng)
    td = Discriminator(CLASSES, preprocess_mode=mode, image_size=size, conv_dim=CONV_DIM)
    sd = tckpt.discriminator_state_dict_from_jax(variables)
    td.load_state_dict({k: torch.tensor(v) for k, v in sd.items()},
                       strict=True)
    return rng, jd, variables, td


def test_discriminator_state_dict_equals_export():
    _, _, variables, _ = _d_pair(1, 65, 0)
    ours = tckpt.discriminator_state_dict_from_jax(variables)
    ref = jckpt.export_torch_discriminator(variables)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


@pytest.mark.parametrize("size", [65, 33])
@pytest.mark.parametrize("mode", [1, 2, 3])
def test_discriminator_train_forward_matches_jax(mode, size):
    rng, jd, variables, td = _d_pair(mode, size, 10 * mode + size)
    x = (rng.randn(2, size, size, CLASSES) * (60.0 if mode == 3 else 2.0)).astype(np.float32)

    def f(params, x):
        (out, p1, p2), mut = jd.apply({**variables, "params": params}, x, train=True,
                                      mutable=["batch_stats", "spectral"])
        return jnp.sum(out * jnp.arange(1.0, 3.0)[:, None, None, None]), (out, p1, p2, mut)

    (_, (out_ref, p1_ref, p2_ref, mut)), (gp_ref, gx_ref) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(variables["params"], jnp.asarray(x))

    td.train()
    tx = _nchw(x).requires_grad_()
    out, p1, p2 = td(tx)
    (out * torch.arange(1.0, 3.0)[:, None, None, None]).sum().backward()
    np.testing.assert_allclose(_nhwc(out), np.asarray(out_ref), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(p1.detach().numpy(), np.asarray(p1_ref), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(p2.detach().numpy(), np.asarray(p2_ref), rtol=1e-4, atol=1e-6)
    after = tckpt.discriminator_state_dict_from_jax({**variables, **mut})
    for k, v in td.state_dict().items():
        if k.endswith(("running_mean", "running_var", "weight_u", "weight_v")):
            np.testing.assert_allclose(v.numpy(), after[k], rtol=1e-5, atol=1e-6, err_msg=k)
    _close_rel(_nhwc(tx.grad), gx_ref, name="dx")
    _close_params(td, tckpt.discriminator_state_dict_from_jax({"params": gp_ref}))


# ------------------------------------------------------------------- losses
def test_pixel_wise_kl_matches_jax():
    rng = np.random.RandomState(4)
    s = (2 * rng.randn(2, 9, 11, CLASSES)).astype(np.float32)
    t = (2 * rng.randn(2, 9, 11, CLASSES)).astype(np.float32)
    ref, g_ref = jax.value_and_grad(jdistill.pixel_wise_kl)(jnp.asarray(s), jnp.asarray(t))
    ts = _nchw(s).requires_grad_()
    ours = tlosses.pixel_wise_kl(ts, _nchw(t))
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    _close_rel(_nhwc(ts.grad), g_ref, rel=1e-5)


@pytest.mark.parametrize("hw,scale", [((65, 65), 0.5), ((33, 33), 0.5), ((20, 28), 0.25)])
def test_pairwise_affinity_loss_matches_jax(hw, scale):
    rng = np.random.RandomState(5)
    fs = rng.randn(2, *hw, 16).astype(np.float32)
    ft = rng.randn(2, *hw, 16).astype(np.float32)
    ref, g_ref = jax.value_and_grad(
        lambda a: jdistill.pairwise_affinity_loss(a, jnp.asarray(ft), scale))(jnp.asarray(fs))
    ts = _nchw(fs).requires_grad_()
    ours = tlosses.pairwise_affinity_loss(ts, _nchw(ft), scale)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-5)
    _close_rel(_nhwc(ts.grad), g_ref, rel=1e-5)


@pytest.mark.parametrize("adv_type", ["wgan-gp", "hinge"])
def test_adversarial_losses_match_jax(adv_type):
    rng = np.random.RandomState(6)
    fake = rng.randn(4, 1, 1, 1).astype(np.float32)
    real = rng.randn(4, 1, 1, 1).astype(np.float32)
    g_ref, gg = jax.value_and_grad(lambda f: jadv.adv_loss_for_g(f, adv_type))(jnp.asarray(fake))
    d_ref, (gf, gr) = jax.value_and_grad(
        lambda f, r: jadv.adv_loss_for_d(f, r, adv_type), argnums=(0, 1))(
            jnp.asarray(fake), jnp.asarray(real))
    tf, tr = torch.from_numpy(fake).requires_grad_(), torch.from_numpy(real).requires_grad_()
    g = tlosses.adv_loss_for_g(tf, adv_type)
    (gtf,) = torch.autograd.grad(g, tf)
    d = tlosses.adv_loss_for_d(tf, tr, adv_type)
    d.backward()
    np.testing.assert_allclose(g.item(), float(g_ref), rtol=1e-6)
    np.testing.assert_allclose(d.item(), float(d_ref), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(gtf.numpy(), np.asarray(gg), rtol=1e-6)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(gf), rtol=1e-6)
    np.testing.assert_allclose(tr.grad.numpy(), np.asarray(gr), rtol=1e-6)


def test_gradient_penalty_matches_jax_with_given_alpha():
    """GP through a train-mode discriminator (mode 1: the preprocess BN sits
    inside the double backward): value and gradients w.r.t. D's parameters,
    with the JAX α fed to the port."""
    rng, jd, variables, td = _d_pair(1, 33, 7)
    real = (2 * rng.randn(2, 33, 33, CLASSES)).astype(np.float32)
    fake = (2 * rng.randn(2, 33, 33, CLASSES)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    alpha = np.asarray(jax.random.uniform(key, (2, 1, 1, 1), jnp.float32))

    def gp_fn(params):
        def score(x):
            (out, _, _), _ = jd.apply({**variables, "params": params}, x, train=True,
                                      mutable=["batch_stats", "spectral"])
            return out
        return jadv.gradient_penalty(score, jnp.asarray(real), jnp.asarray(fake), key, 10.0)

    ref, gp_ref = jax.value_and_grad(gp_fn)(variables["params"])
    td.train()
    ours = tlosses.gradient_penalty(lambda x: td(x)[0], _nchw(real), _nchw(fake),
                                    torch.tensor(alpha), 10.0)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=1e-4)
    _close_params(td, tckpt.discriminator_state_dict_from_jax({"params": gp_ref}))
