"""The port's fused ABN (K6–K8) and conv3x3 probe (K9) vs the JAX package, on the CPU.

The JAX side runs its Pallas kernels in interpret mode, as
tests/test_pallas_bn.py does; the port's wrappers take their plain versions
on CPU tensors. Inputs are made with numpy from a seed and transposed
between NHWC (JAX) and NCHW (port).

Tolerances: in f32 both sides do the same f32 operations, with the batch
statistics summed in another order: outputs and statistics to rtol 1e-5,
gradients to 1e-5 of their largest entry (the gradient sums run over the
whole batch). In bf16 the output is one rounding of nearly the same f32
value, so it may differ by one bf16 ulp; gradients are 1e-2 of their largest
entry (dx is a bf16 tensor, and the weight and bias sums add bf16 terms).
The small ResPSPNet agrees in eval mode to rtol 1e-3 / atol 1e-4, the
tolerance of tests/test_torch_port_models.py: the JAX model computes the PSP
bottleneck in a factored form. In train mode each output, and each updated
running statistic, agrees to 1e-3 of its largest entry: the PSP's 1×1 bin is
a batch norm over 2 values, which amplifies f32 rounding (the JAX model's
own fused and unfused paths differ by 2.3e-4 of the largest logit there, the
port's fused and unfused not at all; measured on this test's basic-block
case). The conv probe: 1e-5 of the largest output in f32, and 2⁻⁷ of it in
bf16 (one rounding of f32 sums taken in another order).
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.ops import batch_norm as jbn
from structure_knowledge_distillation_tpu.ops import pallas_bn as jpbn
from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops import ABN, abn_fused_eval, abn_fused_train
from structure_knowledge_distillation_tpu_torch.ops import fused_bn
from structure_knowledge_distillation_tpu_torch.ops.conv3x3 import conv3x3, conv3x3_plain
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EPS = 1e-5
ACTIVATIONS = ["none", "leaky_relu", "elu"]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GRAD_REL = {"float32": 1e-5, "bfloat16": 1e-2}


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a, np.float32)
                                                 .transpose(0, 3, 1, 2))).to(dtype)


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _close_rel(ours, ref, rel, name=""):
    ref = np.asarray(ref, np.float32)
    np.testing.assert_allclose(np.asarray(ours, np.float32), ref, rtol=0,
                               atol=rel * max(np.abs(ref).max(), 1e-30), err_msg=name)


def _within_bf16_ulp(ours, ref, name=""):
    """|ours − ref| ≤ one bf16 ulp of ref (and ≤ 1e-30 where ref is 0)."""
    ref = np.asarray(ref, np.float32)
    mag = np.maximum(np.abs(ref), np.float32(1e-30))
    ulp = np.exp2(np.floor(np.log2(mag)) - 7)
    err = np.abs(np.asarray(ours, np.float32) - ref)
    assert (err <= ulp).all(), (name, float((err / ulp).max()))


def _inputs(seed, shape=(3, 8, 8, 16)):
    """x, weight, bias and an output cotangent. The normalised values stay
    within about ±3.5 and |w| ≤ 1, so the ELU's output stays off −1, where
    a bf16 output saturates and the inversion log1p(z) is −inf (in the JAX
    package as in the port)."""
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (np.clip(rng.randn(*shape), -3, 3) * 2 + 0.5).astype(np.float32)
    sign = np.where(rng.rand(c) < 0.25, -1.0, 1.0)  # signed: |w| + eps matters
    w = (sign * (0.5 + 0.5 * rng.rand(c))).astype(np.float32)
    b = (0.3 * rng.randn(c)).astype(np.float32)
    ct = rng.randn(*shape).astype(np.float32)
    return x, w, b, ct


# ------------------------------------------------------------ train, eval
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_abn_fused_train_matches_jax(activation, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, ct = _inputs(0)

    def loss(x, w, b):
        z, mean, var = jpbn.abn_fused_train(x, w, b, EPS, activation, 0.01, True, None)
        return jnp.sum(z.astype(jnp.float32) * ct), (z, mean, var)

    (_, (z_ref, mean_ref, var_ref)), (gx, gw, gb) = jax.value_and_grad(
        loss, argnums=(0, 1, 2), has_aux=True)(jnp.asarray(x).astype(jdt), jnp.asarray(w),
                                               jnp.asarray(b))

    tx = _nchw(x, tdt).requires_grad_()
    tw, tb = torch.from_numpy(w).requires_grad_(), torch.from_numpy(b).requires_grad_()
    z, mean, var = abn_fused_train(tx, tw, tb, EPS, activation, 0.01, True)
    (z.float() * _nchw(ct)).sum().backward()
    assert z.dtype == tdt and tx.grad.dtype == tdt and not mean.requires_grad
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(z), _f32(z_ref), rtol=1e-5, atol=1e-5)
    else:
        _within_bf16_ulp(_nhwc(z), _f32(z_ref), "z")
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_ref), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_ref), rtol=1e-5, atol=1e-6)
    _close_rel(_nhwc(tx.grad), _f32(gx), GRAD_REL[dtype], "dx")
    _close_rel(tw.grad.numpy(), gw, GRAD_REL[dtype], "dweight")
    _close_rel(tb.grad.numpy(), gb, GRAD_REL[dtype], "dbias")


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_abn_fused_eval_matches_jax(activation, dtype):
    jdt, tdt = DTYPES[dtype]
    x, w, b, _ = _inputs(1, (2, 4, 5, 8))
    rng = np.random.RandomState(2)
    mean = rng.randn(8).astype(np.float32)
    var = (rng.rand(8) + 0.5).astype(np.float32)
    ref = jpbn.abn_fused_eval(jnp.asarray(x).astype(jdt), jnp.asarray(w), jnp.asarray(b),
                              jnp.asarray(mean), jnp.asarray(var), EPS, activation, 0.01, True)
    with torch.no_grad():
        z = abn_fused_eval(_nchw(x, tdt), torch.from_numpy(w), torch.from_numpy(b),
                           torch.from_numpy(mean), torch.from_numpy(var), EPS, activation,
                           0.01, True)
    assert z.dtype == tdt
    if dtype == "float32":
        np.testing.assert_allclose(_nhwc(z), _f32(ref), rtol=1e-5, atol=1e-5)
    else:
        _within_bf16_ulp(_nhwc(z), _f32(ref), "z")


@pytest.mark.parametrize("activation", ["none", "leaky_relu"])
def test_abn_module_fused_running_stats_match_jax(activation):
    x, w, b, _ = _inputs(3, (2, 6, 7, 5))
    rng = np.random.RandomState(4)
    mean0 = (0.1 * rng.randn(5)).astype(np.float32)
    var0 = (rng.rand(5) + 0.5).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(w), "bias": jnp.asarray(b)},
                 "batch_stats": {"mean": jnp.asarray(mean0), "var": jnp.asarray(var0)}}
    mod = jbn.ABN(activation=activation, fused=True)
    z_ref, mut = mod.apply(variables, jnp.asarray(x), use_running_average=False,
                           mutable=["batch_stats"])
    z_eval_ref = mod.apply({"params": variables["params"], **mut}, jnp.asarray(x),
                           use_running_average=True)

    tmod = ABN(5, activation=activation, fused=True)
    tmod.load_state_dict({"weight": torch.from_numpy(w), "bias": torch.from_numpy(b),
                          "running_mean": torch.from_numpy(mean0),
                          "running_var": torch.from_numpy(var0)})
    z = tmod.train()(_nchw(x))
    np.testing.assert_allclose(_nhwc(z), np.asarray(z_ref), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(), np.asarray(mut["batch_stats"]["mean"]),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(), np.asarray(mut["batch_stats"]["var"]),
                               rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        z_eval = tmod.eval()(_nchw(x))
    np.testing.assert_allclose(_nhwc(z_eval), np.asarray(z_eval_ref), rtol=1e-5, atol=1e-5)


def test_abn_fused_train_has_no_double_backward():
    x, w, b, ct = _inputs(5, (2, 3, 3, 4))
    tx = _nchw(x).requires_grad_()
    z, _, _ = abn_fused_train(tx, torch.from_numpy(w), torch.from_numpy(b), EPS, "leaky_relu")
    # a cotangent that depends on z, as the WGAN-GP's input gradient does
    (gx,) = torch.autograd.grad((torch.tanh(z) * _nchw(ct)).sum(), tx, create_graph=True)
    with pytest.raises(RuntimeError, match="once_differentiable"):
        (gx * gx).sum().backward()


def test_abn_fused_eval_raises_under_grad():
    x, w, b, _ = _inputs(6, (1, 3, 3, 4))
    args = (torch.from_numpy(w), torch.from_numpy(b), torch.zeros(4), torch.ones(4))
    with pytest.raises(RuntimeError, match="no gradient"):
        abn_fused_eval(_nchw(x).requires_grad_(), *args)
    with pytest.raises(RuntimeError, match="no gradient"):
        abn_fused_eval(_nchw(x), torch.from_numpy(w).requires_grad_(), *args[1:])
    z = abn_fused_eval(_nchw(x), *args)  # nothing requires grad: fine with grad enabled
    assert not z.requires_grad
    tmod = ABN(4, fused=True).eval()
    with pytest.raises(RuntimeError, match="no gradient"):
        tmod(_nchw(x))  # the parameters require grad
    with torch.no_grad():
        assert tmod(_nchw(x)).shape == (1, 4, 3, 3)


# ------------------------------------------------------- kernel wrappers
def test_kernel_wrappers_take_plain_versions_on_cpu():
    """On CPU tensors the wrappers are their plain versions and count no
    launch; K8 without `training` is g'·coef."""
    rng = np.random.RandomState(7)
    # a saved output: an ELU's is above −1
    z = torch.from_numpy(np.maximum(rng.randn(2, 3, 4, 5), -0.9).astype(np.float32))
    dz = torch.from_numpy(rng.randn(2, 3, 4, 5).astype(np.float32))
    g, bta, coef, edz, eydz = (torch.from_numpy(rng.rand(3).astype(np.float32) + 0.5)
                               for _ in range(5))
    before = (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
              fused_bn.bn_grad_input.launches)
    for act in ACTIVATIONS:
        assert torch.equal(fused_bn.bn_act(z, g, bta, act), fused_bn.bn_act_plain(z, g, bta, act))
        for a, r in zip(fused_bn.bn_grad_sums(z, dz, g, bta, act),
                        fused_bn.bn_grad_sums_plain(z, dz, g, bta, act)):
            assert torch.equal(a, r)
        for training in (True, False):
            assert torch.equal(
                fused_bn.bn_grad_input(z, dz, g, bta, coef, edz, eydz, act, 0.01, training),
                fused_bn.bn_grad_input_plain(z, dz, g, bta, coef, edz, eydz, act, 0.01,
                                             training))
    plain = fused_bn.bn_grad_input_plain(z, dz, g, bta, coef, edz, eydz, "none", 0.01, False)
    torch.testing.assert_close(plain, dz * coef.view(1, -1, 1, 1), rtol=0, atol=0)
    assert (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
            fused_bn.bn_grad_input.launches) == before


def test_kernel_wrappers_check_their_inputs():
    z = torch.zeros(2, 3, 4, 4)
    one = torch.ones(3)
    with pytest.raises(ValueError, match="per-channel"):
        fused_bn.bn_act(z, torch.ones(4), one)
    with pytest.raises(TypeError):
        fused_bn.bn_act(z.half(), one, one)
    with pytest.raises(ValueError, match="activation"):
        fused_bn.bn_act(z, one, one, "relu")
    with pytest.raises(ValueError, match="agree"):
        fused_bn.bn_grad_sums(z, z[:1], one, one)
    with pytest.raises(ValueError, match="w"):
        conv3x3(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 2, 5))
    with pytest.raises(TypeError):
        conv3x3(torch.zeros(1, 4, 4, 3), torch.zeros(3, 3, 3, 5, dtype=torch.bfloat16))


# ---------------------------------------------------- ResPSPNet(bn_fused)
@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def fused_case(request):
    """A small bn_fused JAX model with randomised BN parameters and running
    statistics, and its train- and eval-mode outputs on a batch of two
    images of different contrast (a train-mode BN over the PSP's 1×1 bin of
    two near-equal images is ill-conditioned in f32)."""
    block = request.param
    rng = np.random.RandomState(10 if block == "basic" else 11)
    x = rng.randn(2, 64, 64, 3).astype(np.float32)
    x[1] = 3.0 * x[1] + 1.0
    kw = dict(block=block, layers=(1, 1, 1, 1), num_classes=7, width_mult=0.25, drop_rate=0.0)
    # the variables of the unfused model are those of the fused one
    variables = JaxResPSPNet(**kw).init(jax.random.PRNGKey(0), jnp.asarray(x[:1]), train=False)

    def randomize(tree, fn):
        return jax.tree_util.tree_map_with_path(
            lambda p, a: jnp.asarray(fn(p[-1].key, np.asarray(a))), tree)

    variables = {
        "params": randomize(variables["params"], lambda k, a: (
            rng.randn(*a.shape).astype(np.float32) if k == "weight" and a.ndim == 1
            else (0.1 * rng.randn(*a.shape)).astype(np.float32) if k == "bias" else a)),
        "batch_stats": randomize(variables["batch_stats"], lambda k, a: (
            (0.1 * rng.randn(*a.shape)).astype(np.float32) if k == "mean"
            else (rng.rand(*a.shape) + 0.5).astype(np.float32))),
    }
    jmodel = JaxResPSPNet(**kw, bn_fused=True)
    train_fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=True, mutable=["batch_stats"]))
    eval_fn = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    train_outs, mut = train_fn(variables, jnp.asarray(x))
    eval_outs = eval_fn(variables, jnp.asarray(x))
    return (block, x, variables, [np.asarray(o) for o in train_outs],
            tckpt.state_dict_from_jax({"params": variables["params"], **mut}),
            [np.asarray(o) for o in eval_outs])


def _fused_port_model(block, variables):
    model = ResPSPNet(block, (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, bn_fused=True)
    model.load_state_dict({k: torch.tensor(v) for k, v in
                           tckpt.state_dict_from_jax(variables).items()}, strict=True)
    return model


@pytest.mark.parametrize("mode", ["train", "eval"])
def test_respspnet_bn_fused_matches_jax(fused_case, mode):
    block, x, variables, train_ref, stats_ref, eval_ref = fused_case
    model = _fused_port_model(block, variables)
    assert sum(isinstance(m, ABN) and m.fused for m in model.modules()) == (
        sum(isinstance(m, ABN) for m in model.modules()))
    xt = _nchw(x)
    if mode == "train":
        outs = model.train()(xt)
        refs = train_ref
    else:
        with torch.no_grad():
            outs = model.eval()(xt)
        refs = eval_ref
    for i, (ours, ref) in enumerate(zip(outs, refs)):
        if mode == "train":
            _close_rel(_nhwc(ours), ref, 1e-3, f"output {i}")
        else:
            np.testing.assert_allclose(_nhwc(ours), ref, rtol=1e-3, atol=1e-4,
                                       err_msg=f"output {i}")
    if mode == "train":
        got = model.state_dict()
        for k, v in stats_ref.items():
            if k.endswith(("running_mean", "running_var")):
                _close_rel(got[k].numpy(), v, 1e-3, k)


# ------------------------------------------------------------ conv probe
def _load_probe():
    path = os.path.join(REPO, "scripts", "bench_pallas_conv.py")
    spec = importlib.util.spec_from_file_location("bench_pallas_conv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("cout", [8, 16])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_conv3x3_plain_matches_pallas_probe(cout, dtype):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(cout)
    x = rng.randn(1, 32, 16, 8).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, 8, cout)).astype(np.float32)
    ref = _f32(_load_probe().pallas_conv3x3(jnp.asarray(x).astype(jdt),
                                            jnp.asarray(w).astype(jdt)))
    ours = conv3x3(torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt))
    assert ours.dtype == tdt and ours.shape == (1, 32, 16, cout) and ours.is_contiguous()
    assert torch.equal(ours, conv3x3_plain(torch.from_numpy(x).to(tdt),
                                           torch.from_numpy(w).to(tdt)))
    _close_rel(ours.float().numpy(), ref, 1e-5 if dtype == "float32" else 2.0 ** -7)
