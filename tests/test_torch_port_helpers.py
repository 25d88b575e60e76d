"""The small helpers against their JAX twins.

  * `utils.count_params` / `log_param_count`: the port's count of the
    R18 and R101 PSPNets, ESPNet-C and the SAGAN D equals the JAX count of
    the same model's `params` tree, whose leaves map one to one onto the
    port's parameters (`state_dict_from_jax`, `espnet_state_dict_from_jax`,
    `discriminator_state_dict_from_jax`, each tensor once: BN running
    statistics and spectral u/v are buffers, an SNConv's `weight_bar` the
    kernel leaf), with the same log line;
  * `training.evaluate.make_predictor`: the whole-image eval forward on
    shared weights, to f32 rounding;
  * `data.native.native_confusion`: bit-equal to the JAX wrapper and to the
    port's device `confusion_matrix`;
  * `data.synthetic.synthetic_batches`: bit-equal batches.
"""

from __future__ import annotations

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.data import synthetic_batches as jax_synthetic_batches
from structure_knowledge_distillation_tpu.data.native import native_confusion as jax_confusion
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.models.espnet import ESPNetC as JaxESPNetC
from structure_knowledge_distillation_tpu.training.evaluate import (
    make_predictor as jax_make_predictor,
)
from structure_knowledge_distillation_tpu.utils import count_params as jax_count_params
from structure_knowledge_distillation_tpu.utils import log_param_count as jax_log_param_count
from structure_knowledge_distillation_tpu_torch.data import synthetic_batches
from structure_knowledge_distillation_tpu_torch.data.native import native_confusion
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ESPNetC, ResPSPNet
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    confusion_matrix,
    make_predictor,
)
from structure_knowledge_distillation_tpu_torch.utils import count_params, log_param_count

KEY = jax.random.PRNGKey(0)


def _zeros(tree):
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), tree)


def _pspnet(block, layers):
    jmodel = JaxResPSPNet(block=block, layers=layers, num_classes=19)
    variables = jax.eval_shape(lambda: jmodel.init(KEY, jnp.zeros((1, 64, 64, 3)), train=False))
    with torch.device("meta"):
        model = ResPSPNet(block, layers, 19)
    return variables, tckpt.state_dict_from_jax, model


def _espnet():
    jmodel = JaxESPNetC(num_classes=11, p=2, q=8)
    variables = jax.eval_shape(lambda: jmodel.init(KEY, jnp.zeros((1, 64, 64, 3)), train=False))
    with torch.device("meta"):
        model = ESPNetC(11, p=2, q=8)
    return variables, tckpt.espnet_state_dict_from_jax, model


def _discriminator():
    jmodel = JaxDiscriminator(preprocess_mode=1, image_size=65, conv_dim=64)
    variables = jax.eval_shape(lambda: jmodel.init(KEY, jnp.zeros((1, 65, 65, 19)), train=False))
    with torch.device("meta"):
        model = Discriminator(19, 1, 65, 64)
    return variables, tckpt.discriminator_state_dict_from_jax, model


MODELS = {
    "r18_pspnet": lambda: _pspnet("basic", (2, 2, 2, 2)),
    "r101_pspnet": lambda: _pspnet("bottleneck", (3, 4, 23, 3)),
    "espnet_c": _espnet,
    "sagan_d": _discriminator,
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_count_params_matches_jax(name, caplog):
    variables, to_torch, model = MODELS[name]()
    params_only = {"params": variables["params"]}
    mapped = to_torch(_zeros(params_only))
    names = dict(model.named_parameters())
    # the params tree maps onto the parameters one to one, shape for shape
    assert sorted(mapped) == sorted(names), sorted(set(mapped) ^ set(names))
    for k, v in mapped.items():
        assert tuple(v.shape) == tuple(names[k].shape), k
    want = jax_count_params(variables["params"])
    assert count_params(model) == want > 0
    with caplog.at_level(logging.INFO):
        assert jax_log_param_count(variables["params"], name) == want
        assert log_param_count(model, name) == want
    lines = [r.getMessage() for r in caplog.records if "Number of params" in r.getMessage()]
    assert len(lines) == 2 and lines[0] == lines[1], lines


def test_make_predictor_matches_jax():
    jmodel = JaxResPSPNet(block="basic", layers=(1, 1, 1, 1), num_classes=7, width_mult=0.25)
    rng = np.random.RandomState(0)
    images = rng.randn(2, 64, 80, 3).astype(np.float32)
    variables = jax.jit(lambda k: jmodel.init(k, jnp.zeros((1, 64, 64, 3)), train=False))(KEY)
    out_size = (70, 90)
    want = np.asarray(jax_make_predictor(jmodel, out_size)(variables, jnp.asarray(images)))

    model = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25)
    model.load_state_dict({k: torch.tensor(np.asarray(v))
                           for k, v in tckpt.state_dict_from_jax(variables).items()}, strict=True)
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(images.transpose(0, 3, 1, 2).copy())
        got = make_predictor(model, out_size)(x)
    assert got.dtype == torch.float32 and tuple(got.shape) == (2, 7, *out_size)
    np.testing.assert_allclose(got.numpy().transpose(0, 2, 3, 1), want, rtol=1e-4, atol=1e-4)


def test_native_confusion_matches_jax_and_the_device_confusion():
    rng = np.random.RandomState(1)
    gt = rng.randint(0, 19, (2, 97, 131)).astype(np.int32)
    gt[:, :5] = 255
    gt[0, 7, :9] = -1          # outside [0, C): skipped, as the C loop skips it
    pred = rng.randint(0, 19, gt.shape).astype(np.int32)
    pred[1, 3, :4] = 40
    got = native_confusion(pred, gt, 19)
    assert got.dtype == np.int64 and got.shape == (19, 19)
    np.testing.assert_array_equal(got, jax_confusion(pred, gt, 19))
    inside = (gt >= 0) & (pred < 19)   # the device confusion expects class maps in range
    device = confusion_matrix(torch.from_numpy(np.where(inside, pred, 0)),
                              torch.from_numpy(np.where(inside, gt, 255)), 19)
    np.testing.assert_array_equal(got, device.numpy())


def test_synthetic_batches_match_jax():
    got = list(synthetic_batches(2, 3, (24, 40), 19, seed=5))
    want = list(jax_synthetic_batches(2, 3, (24, 40), 19, seed=5))
    assert len(got) == len(want) == 3
    for (gi, gl), (wi, wl) in zip(got, want):
        assert gi.dtype == wi.dtype and gl.dtype == wl.dtype
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
