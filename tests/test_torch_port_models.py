"""Port ResPSPNet vs the JAX ResPSPNet on shared weights, and the checkpoint
bridge between them.

Small models (layers (1,1,1,1), width_mult 0.25, 7 classes) with randomised
BN parameters and running statistics. The JAX model computes the PSP
bottleneck in its factored form and the port the literal concat + conv, so
the outputs agree up to float reassociation: rtol=1e-3, atol=1e-4, the
tolerance of tests/test_torch_forward_parity.py.
"""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

LAYERS = (1, 1, 1, 1)
WIDTH = 0.25
CLASSES = 7
OUTPUTS = ("logits", "dsn", "feat_after_psp", "x4", "x3", "x2", "x1")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _randomize(tree, rng, key_fn):
    if isinstance(tree, dict):
        return {k: (_randomize(v, rng, key_fn) if isinstance(v, dict)
                    else key_fn(k, np.asarray(v)))
                for k, v in tree.items()}
    raise TypeError(type(tree))


@pytest.fixture(scope="module", params=["basic", "bottleneck"])
def case(request):
    block = request.param
    rng = np.random.RandomState(0 if block == "basic" else 1)
    x = rng.randn(1, 64, 64, 3).astype(np.float32)
    jmodel = JaxResPSPNet(block=block, layers=LAYERS, num_classes=CLASSES,
                          width_mult=WIDTH)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)
    variables = jax.tree.map(np.asarray, variables)

    def params_fn(name, v):
        if name == "weight":  # ABN gamma, signed so that |w| + eps matters
            return rng.randn(*v.shape).astype(np.float32)
        if name == "bias":
            return (0.1 * rng.randn(*v.shape)).astype(np.float32)
        return v

    variables = {
        "params": _randomize(variables["params"], rng, params_fn),
        "batch_stats": _randomize(variables["batch_stats"], rng,
                                  lambda k, v: (rng.rand(*v.shape) + 0.5).astype(np.float32)),
    }
    outs = [np.asarray(o) for o in jmodel.apply(variables, jnp.asarray(x), train=False)]
    return block, x, variables, outs


def _port_model(block):
    return ResPSPNet(block=block, layers=LAYERS, num_classes=CLASSES,
                     width_mult=WIDTH, generator=torch.Generator().manual_seed(0))


def test_state_dict_from_jax_equals_export(case):
    _, _, variables, _ = case
    ours = tckpt.state_dict_from_jax(variables)
    ref = jckpt.export_torch_respspnet(variables)
    assert list(ours) == list(ref)
    for k in ref:
        assert ours[k].dtype == ref[k].dtype, k
        np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)


def test_forward_matches_jax(case):
    block, x, variables, ref_outs = case
    model = _port_model(block)
    sd = {k: torch.tensor(v)
          for k, v in tckpt.state_dict_from_jax(variables).items()}
    model.load_state_dict(sd, strict=True)
    model.eval()
    with torch.no_grad():
        outs = model(torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))))
    assert len(outs) == 7
    for name, ours, ref in zip(OUTPUTS, outs, ref_outs):
        np.testing.assert_allclose(ours.numpy().transpose(0, 2, 3, 1), ref,
                                   rtol=1e-3, atol=1e-4, err_msg=name)


def test_pth_roundtrip_with_module_prefix_and_head_remap(case, tmp_path):
    """A released-style checkpoint: DataParallel `module.` prefix, the
    teachers' `head.0.*` (PSP) / `head.1.*` (classifier) layout, plus `fc.*`
    and `num_batches_tracked` entries that have no counterpart."""
    block, _, variables, _ = case
    sd = tckpt.state_dict_from_jax(variables)
    released = {}
    for k, v in sd.items():
        if k.startswith("pspmodule."):
            k = "head.0." + k[len("pspmodule."):]
        elif k.startswith("head."):
            k = "head.1." + k[len("head."):]
        released["module." + k] = torch.tensor(v)
    released["module.fc.weight"] = torch.zeros(10, 4)
    released["module.bn1.num_batches_tracked"] = torch.tensor(3)
    path = tmp_path / "released.pth"
    torch.save({"state_dict": released}, path)

    model = _port_model(block)
    skipped = tckpt.load_reference_state_dict(model, tckpt.load_torch_state_dict(str(path)))
    assert sorted(skipped) == ["module.bn1.num_batches_tracked", "module.fc.weight"]
    got = model.state_dict()
    assert set(got) == set(sd)
    for k, v in sd.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)

    # a mismatched shape is skipped, not loaded
    bad = {"head.weight": torch.zeros(3, 3, 1, 1)}
    assert tckpt.load_reference_state_dict(model, bad) == [
        f"head.weight (shape (3, 3, 1, 1) vs {tuple(got['head.weight'].shape)})"]


def test_port_imports_without_jax():
    code = (
        "import sys, importlib, pkgutil\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import structure_knowledge_distillation_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m == 'structure_knowledge_distillation_tpu'"
        " or m.startswith('structure_knowledge_distillation_tpu.')]\n"
        "assert not bad, bad\n"
        "new = {'data.cache', 'data.native', 'data.lists', 'data.prefetch',"
        " 'utils.metrics_writer', 'utils.logging_utils', 'models.fold', 'cli.export'}\n"
        "assert {pkg.__name__ + '.' + n for n in new} <= set(names), names\n"
        "print(len(names))\n"
    )
    env = dict(os.environ)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 40
