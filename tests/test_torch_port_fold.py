"""BN folding: the port's `models/fold.py::fold_bn_state_dict` and
`ResPSPNet(fold_bn=True)` against the JAX package's `fold_bn_variables` and
folded `ResPSPNet`, on the same numpy-seeded variables (tests/export_cases.py:
the full-width R18 and an R101 at width_mult 0.125, 64×64).

Tolerances: the fold runs in float64 on both sides and casts to f32, so the
folded tensors agree within 1 f32 ulp; the forwards within rtol 1e-3 /
atol 1e-4 (the JAX PSP bottleneck is factored, the port's the literal
concat + conv, as in tests/test_torch_port_models.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from export_cases import (
    ARCHS,
    CLASSES,
    jax_model,
    model_input,
    port_model,
    port_state_dict,
    raw_image,
    variables,
)
from structure_knowledge_distillation_tpu.models.fold import fold_bn_variables
from structure_knowledge_distillation_tpu_torch.models import (
    ResPSPNet,
    abn_conv_pairs,
    fold_bn_state_dict,
)
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import ABN
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.evaluate import make_fast_val_fn


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", params=sorted(ARCHS))
def case(request):
    arch = request.param
    tree = variables(arch, seed=0 if arch == "r18" else 1)
    x = model_input(raw_image(7))
    jax_folded = fold_bn_variables(tree)
    outs = jax_model(arch, fold_bn=True).apply(
        jax_folded, jnp.asarray(x.transpose(0, 2, 3, 1)), train=False)
    return arch, tree, jax_folded, x, [np.asarray(o) for o in outs[:2]]


def test_fold_matches_jax_fold_bn_variables(case):
    """Key for key, within 1 f32 ulp: the port's fold of the port's state
    dict against the JAX fold mapped to the port's names."""
    _, tree, jax_folded, _, _ = case
    ours = fold_bn_state_dict(port_state_dict(tree))
    ref = tckpt.state_dict_from_jax(jax_folded)
    assert set(ours) == set(ref)
    assert not any(k.endswith(("running_mean", "running_var")) for k in ours)
    for k, v in ref.items():
        assert ours[k].dtype == torch.float32, k
        np.testing.assert_array_max_ulp(ours[k].numpy(), v, maxulp=1)
    # numpy input gives the same tensors
    again = fold_bn_state_dict(tckpt.state_dict_from_jax(tree))
    for k, v in ours.items():
        assert torch.equal(again[k], v), k


def test_folded_forward_matches_jax(case):
    """The JAX folded tree, carried across by `state_dict_from_jax`, loads
    strictly into `ResPSPNet(fold_bn=True)`, whose logits and DSN output
    equal the JAX folded model's."""
    arch, _, jax_folded, x, ref = case
    model = port_model(arch, fold_bn=True)
    model.load_state_dict(port_state_dict(jax_folded), strict=True)
    with torch.no_grad():
        outs = model.eval()(torch.from_numpy(x))
    for name, ours, want in zip(("logits", "dsn"), outs[:2], ref):
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), want,
                                   rtol=1e-3, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("block", ["basic", "bottleneck"])
def test_folded_keys_follow_the_module_tree(block):
    """The folded model's state dict has exactly the fold's keys, in its
    order; the fold's (ABN, conv) pairs are the module tree's (each ABN
    registered right after its conv in the same parent)."""
    layers = (2, 2, 2, 2) if block == "basic" else (1, 2, 1, 1)
    plain = ResPSPNet(block, layers, CLASSES, width_mult=0.25)
    folded = ResPSPNet(block, layers, CLASSES, width_mult=0.25, fold_bn=True)
    out = fold_bn_state_dict(plain.state_dict())
    assert list(out) == list(folded.state_dict())
    folded.load_state_dict(out, strict=True)

    walked = {}
    for parent_name, parent in plain.named_modules():
        children = list(parent.named_children())
        for (prev_name, prev), (name, child) in zip(children, children[1:]):
            if isinstance(child, ABN):
                assert isinstance(prev, nn.Conv2d), (parent_name, name)
                prefix = parent_name + "." if parent_name else ""
                walked[prefix + name] = prefix + prev_name
    assert abn_conv_pairs(plain.state_dict()) == walked
    n_abn = sum(isinstance(m, ABN) for m in plain.modules())
    assert len(walked) == n_abn


def test_folded_model_has_no_abn():
    """`fold_bn` overrides `bn_fused`: no ABN, no buffer, the bare
    activations, and a bias on every conv."""
    model = ResPSPNet("bottleneck", (1, 1, 1, 1), CLASSES, width_mult=0.25,
                      bn_fused=True, fold_bn=True)
    assert not any(isinstance(m, ABN) for m in model.modules())
    assert not list(model.buffers())
    assert all(m.bias is not None for m in model.modules() if isinstance(m, nn.Conv2d))
    assert isinstance(model.bn1, nn.Identity)
    assert isinstance(model.layer1[0].downsample[1], nn.Identity)
    assert isinstance(model.pspmodule.stages[0][2], nn.LeakyReLU)
    assert model.pspmodule.stages[0][2].negative_slope == 0.01
    assert isinstance(model.dsn[1], nn.LeakyReLU)
    with pytest.raises(KeyError, match="not an ABN slot"):
        abn_conv_pairs({"head.running_mean": torch.zeros(3)})


def test_folded_fast_path_matches_unfolded(case):
    """The eval fast path (`make_fast_val_fn`: the plain argmax on the CPU)
    gives the folded model the unfolded one's class map and confusion."""
    arch, tree, _, _, _ = case
    plain = port_model(arch)
    plain.load_state_dict(port_state_dict(tree), strict=True)
    folded = port_model(arch, fold_bn=True)
    folded.load_state_dict(fold_bn_state_dict(plain.state_dict()), strict=True)
    image = torch.from_numpy(model_input(raw_image(3, size=(48, 80))))
    label = torch.from_numpy(np.random.RandomState(3).randint(0, CLASSES, (48, 80))
                             .astype(np.uint8))
    with torch.no_grad():
        pred_p, conf_p = make_fast_val_fn(plain.eval(), (48, 80), CLASSES)(image, label, 48, 80)
        pred_f, conf_f = make_fast_val_fn(folded.eval(), (48, 80), CLASSES)(image, label, 48, 80)
        logits = plain(image)[0]
    assert (pred_f == pred_p).float().mean().item() >= 0.999
    assert int(conf_f.sum()) == int(conf_p.sum()) == 48 * 80
    want = F.interpolate(logits, (48, 80), mode="bilinear", align_corners=True).argmax(1)[0]
    assert (pred_p.long() == want).float().mean().item() >= 0.999
