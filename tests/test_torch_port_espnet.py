"""The port's ESPNet-C vs the JAX ESPNetC on shared weights, and the weight
map between them (`espnet_state_dict_from_jax`).

A small ESPNet-C (p=1, q=2, 11 classes) at 64×96, batch 2, f32, with
randomised ABN weights (signed, so |w| + eps matters), biases, PReLU slopes
and running statistics, crossed over with `espnet_state_dict_from_jax` and
loaded strictly. Eval and train mode: all 7 outputs, the updated running
statistics (train) and the parameter gradients of a fixed linear loss on the
two heads and the feature agree at rtol 1e-3 / atol 1e-4 (the tolerance of
tests/test_torch_port_models.py). In bf16 both sides round every layer's
output to bf16 in their own order of operations, so the outputs are held to
4 bf16 ulps of each output's largest magnitude (2⁻⁶ of it) and the class
maps to 99 % agreement.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.models import ESPNetC as JaxESPNetC
from structure_knowledge_distillation_tpu_torch.models import ESPNetC
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

CLASSES = 11
P, Q = 1, 2
SHAPE = (2, 64, 96, 3)
RTOL, ATOL = 1e-3, 1e-4
BF16_REL = 2.0 ** -6
OUTPUTS = ("logits", "aux", "feat", "l3c", "l2c", "l1c", "l1")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


def _randomize(tree, rng):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _randomize(v, rng)
            continue
        v = np.asarray(v)
        if k == "weight":  # ABN gamma
            sign = np.where(rng.rand(*v.shape) < 0.25, -1.0, 1.0)
            out[k] = (sign * (rng.rand(*v.shape) + 0.5)).astype(np.float32)
        elif k == "bias":
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "alpha":
            out[k] = rng.uniform(0.05, 0.5, v.shape).astype(np.float32)
        elif k == "mean":
            out[k] = (0.1 * rng.randn(*v.shape)).astype(np.float32)
        elif k == "var":
            out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
        else:
            out[k] = v
    return out


@pytest.fixture(scope="module")
def shared():
    rng = np.random.RandomState(3)
    x = rng.randn(*SHAPE).astype(np.float32)
    x[1] = 2.0 * x[1] + 0.5  # two images of different statistics
    jmodel = JaxESPNetC(num_classes=CLASSES, p=P, q=Q)
    variables = jax.tree.map(np.asarray, jmodel.init(jax.random.PRNGKey(0),
                                                     jnp.asarray(x[:1]), train=False))
    variables = {"params": _randomize(variables["params"], rng),
                 "batch_stats": _randomize(variables["batch_stats"], rng)}
    weights = [rng.randn(*s).astype(np.float32) for s in
               ((2, 8, 12, CLASSES), (2, 16, 24, CLASSES), (2, 8, 12, 256))]
    return x, variables, weights


def _port(variables, dtype=None):
    model = ESPNetC(CLASSES, p=P, q=Q, dtype=dtype, generator=torch.Generator().manual_seed(0))
    sd = {k: torch.from_numpy(np.ascontiguousarray(v))
          for k, v in tckpt.espnet_state_dict_from_jax(variables).items()}
    model.load_state_dict(sd, strict=True)
    return model


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def test_state_dict_from_jax_names_every_tensor(shared):
    """The map covers exactly the port's state dict, shapes included."""
    _, variables, _ = shared
    sd = tckpt.espnet_state_dict_from_jax(variables)
    model = ESPNetC(CLASSES, p=P, q=Q)
    target = model.state_dict()
    assert sorted(sd) == sorted(target)
    for k, v in sd.items():
        assert tuple(v.shape) == tuple(target[k].shape), k
    n_params = sum(np.asarray(v).size for v in jax.tree.leaves(variables["params"]))
    assert n_params == sum(p.numel() for p in model.parameters())


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_forward_matches_jax(shared, train):
    x, variables, _ = shared
    jmodel = JaxESPNetC(num_classes=CLASSES, p=P, q=Q)
    if train:
        jouts, mut = jmodel.apply(variables, jnp.asarray(x), train=True,
                                  mutable=["batch_stats"])
    else:
        jouts = jmodel.apply(variables, jnp.asarray(x), train=False)
    model = _port(variables).train(train)
    with torch.no_grad():
        outs = model(_nchw(x))
    assert len(outs) == 7
    for name, a, b in zip(OUTPUTS, outs, jouts):
        np.testing.assert_allclose(_nhwc(a), np.asarray(b), rtol=RTOL, atol=ATOL, err_msg=name)
    if train:
        got = {k: v.numpy() for k, v in model.state_dict().items()}
        want = tckpt.espnet_state_dict_from_jax({"batch_stats": mut["batch_stats"]})
        assert want and all(k.endswith(("running_mean", "running_var")) for k in want)
        for k, v in want.items():
            np.testing.assert_allclose(got[k], v, rtol=RTOL, atol=ATOL, err_msg=k)


def test_parameter_gradients_match_jax(shared):
    """Train mode, the gradient of Σ w·(logits, aux, feat) w.r.t. every
    parameter (through the batch statistics of every ABN)."""
    x, variables, weights = shared
    jmodel = JaxESPNetC(num_classes=CLASSES, p=P, q=Q)

    def jloss(params):
        outs, _ = jmodel.apply({"params": params, "batch_stats": variables["batch_stats"]},
                               jnp.asarray(x), train=True, mutable=["batch_stats"])
        return sum(jnp.sum(o * w) for o, w in zip(outs[:3], weights))

    jgrads = tckpt.espnet_state_dict_from_jax(
        {"params": jax.grad(jloss)(jax.tree.map(jnp.asarray, variables["params"]))})
    model = _port(variables).train()
    outs = model(_nchw(x))
    loss = sum((o * _nchw(w)).sum() for o, w in zip(outs[:3], weights))
    loss.backward()
    grads = dict(model.named_parameters())
    assert sorted(jgrads) == sorted(grads)
    for k, g in jgrads.items():
        np.testing.assert_allclose(grads[k].grad.numpy(), g, rtol=RTOL,
                                   atol=ATOL, err_msg=k)


def test_bf16_forward_matches_jax(shared):
    """bf16 compute on both sides (eval mode): every output within 2⁻⁶ of
    its largest magnitude, the class maps in ≥ 99 % agreement."""
    x, variables, _ = shared
    jouts = JaxESPNetC(num_classes=CLASSES, p=P, q=Q, dtype=jnp.bfloat16).apply(
        variables, jnp.asarray(x), train=False)
    with torch.no_grad():
        outs = _port(variables, torch.bfloat16).eval()(_nchw(x))
    for name, a, b in zip(OUTPUTS, outs, jouts):
        assert a.dtype == torch.bfloat16, name
        want = np.asarray(b.astype(jnp.float32))
        scale = float(np.abs(want).max())
        np.testing.assert_allclose(_nhwc(a), want, rtol=0, atol=BF16_REL * scale,
                                   err_msg=name)
    agree = (_nhwc(outs[0]).argmax(-1) == np.asarray(jouts[0].astype(jnp.float32)).argmax(-1))
    assert agree.mean() >= 0.99


def test_hff_adds_the_last_channels_where_widths_differ():
    """ESP(64): branch widths 16, 12, 12, 12, 12 and a 16-channel reduction.
    With the dilated branches 1..4 zeroed, every fused level above the first
    is the LAST 12 channels of the first branch (NCHW `prev[:, -12:]`), and
    the residual adds the input."""
    from structure_knowledge_distillation_tpu_torch.models.espnet import ESP

    block = ESP(64, 64)
    assert block.widths == [16, 12, 12, 12, 12]
    assert ESP(128, 128).widths == [28, 25, 25, 25, 25]
    assert block.reduce.out_channels == 16
    with torch.no_grad():
        for i in range(1, 5):
            getattr(block, f"spp_{i}").weight.zero_()
    seen = {}
    block.bn.register_forward_pre_hook(lambda m, args: seen.setdefault("in", args[0]))
    x = torch.randn(1, 64, 8, 8)
    with torch.no_grad():
        block.eval()(x)
        first = block.spp_0(block.reduce(x))
    expect = torch.cat([first] + [first[:, -12:]] * 4, dim=1) + x
    torch.testing.assert_close(seen["in"], expect)
