"""Port ops vs their JAX counterparts on the same numpy inputs (NHWC↔NCHW).

resize (and its interpolation matrices, which must be equal exactly),
ceil-mode max pool at the shapes that give the model its 65×65 and 129×257
stride-8 maps, adaptive average pool for the PSP bins (and its gradient
against JAX's and, bit for bit but where 2 × 2 bins overlap, against
torch's own), and eval-mode ABN.
Tolerance atol=1e-5: both sides compute in f32 from the same operators; only
the order of float operations differs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu.ops import batch_norm as jbn
from structure_knowledge_distillation_tpu.ops import pooling as jpool
from structure_knowledge_distillation_tpu.ops import resize as jresize
from structure_knowledge_distillation_tpu_torch.ops import batch_norm as tbn
from structure_knowledge_distillation_tpu_torch.ops import pooling as tpool
from structure_knowledge_distillation_tpu_torch.ops import resize as tresize
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import tap_tables

ATOL = 1e-5


def _nchw(x_nhwc):
    return torch.from_numpy(np.ascontiguousarray(x_nhwc.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("n_in,n_out", [(1, 5), (5, 1), (9, 64), (65, 512),
                                        (129, 1024), (257, 2048), (64, 13)])
def test_interp_matrix_equal_exactly(n_in, n_out):
    ours = tresize.interp_matrix_align_corners(n_in, n_out).numpy()
    ref = np.asarray(jresize.interp_matrix_align_corners(n_in, n_out))
    assert ours.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(ours, ref)
    # the kernel's (lo, hi, w_lo, w_hi) tables rebuild the same matrix bit for bit
    idx, wt = tap_tables(n_in, n_out)
    dense = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    dense[rows, idx[0]] += wt[0]
    dense[rows, idx[1]] += wt[1]
    np.testing.assert_array_equal(dense, ref)
    # one tap (the last sample, or a 1-sample axis): the high weight is 0
    assert (wt[1][idx[0] == idx[1]] == 0).all()


@pytest.mark.parametrize("shape,size", [((2, 9, 9, 5), (64, 64)),
                                        ((1, 13, 17, 3), (32, 70)),
                                        ((2, 6, 6, 4), (65, 65)),
                                        ((1, 65, 65, 2), (17, 33))])
def test_resize_matches_jax(shape, size):
    x = np.random.RandomState(0).randn(*shape).astype(np.float32)
    ref = np.asarray(jresize.resize_bilinear_align_corners(jnp.asarray(x), size))
    ours = _nhwc(tresize.resize_bilinear_align_corners(_nchw(x), size))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw,expect", [((129, 129), (65, 65)), ((257, 513), (129, 257)),
                                       ((64, 64), (33, 33)), ((10, 7), (6, 4))])
def test_max_pool_ceil_matches_jax(hw, expect):
    x = np.random.RandomState(1).randn(1, *hw, 3).astype(np.float32)
    ref = np.asarray(jpool.max_pool_2d(jnp.asarray(x), (3, 3), (2, 2), (1, 1),
                                       ceil_mode=True))
    ours = _nhwc(tpool.max_pool_2d(_nchw(x), (3, 3), (2, 2), (1, 1), ceil_mode=True))
    assert ours.shape[1:3] == expect == ref.shape[1:3]
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(65, 65), (17, 33), (129, 257)])
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_matches_jax(hw, bins):
    x = np.random.RandomState(2).randn(2, *hw, 4).astype(np.float32)
    ref = np.asarray(jpool.adaptive_avg_pool_2d(jnp.asarray(x), (bins, bins)))
    ours = _nhwc(tpool.adaptive_avg_pool_2d(_nchw(x), (bins, bins)))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


@pytest.mark.parametrize("hw", [(65, 65), (13, 33), (33, 7)])
@pytest.mark.parametrize("bins", [1, 2, 3, 6])
def test_adaptive_avg_pool_grad(hw, bins):
    """The gradient against the JAX VJP, and against torch's own backward bit
    for bit except at inputs that 2 × 2 overlapping bins hold (four terms
    summed in another order)."""
    rng = np.random.RandomState(5)
    x = rng.randn(2, *hw, 4).astype(np.float32)
    g = rng.randn(2, bins, bins, 4).astype(np.float32)
    _, vjp = jax.vjp(lambda t: jpool.adaptive_avg_pool_2d(t, (bins, bins)), jnp.asarray(x))
    ref = np.asarray(vjp(jnp.asarray(g))[0])
    xt = _nchw(x).requires_grad_(True)
    tpool.adaptive_avg_pool_2d(xt, (bins, bins)).backward(_nchw(g))
    np.testing.assert_allclose(_nhwc(xt.grad), ref, rtol=1e-6, atol=1e-7)
    xs = _nchw(x).requires_grad_(True)
    F.adaptive_avg_pool2d(xs, (bins, bins)).backward(_nchw(g))
    two = [tpool._bin_taps_np(n, bins)[2].astype(bool) for n in hw]
    corner = torch.from_numpy(two[0][:, None] & two[1][None, :])
    assert torch.equal(xt.grad[..., ~corner], xs.grad[..., ~corner])
    torch.testing.assert_close(xt.grad, xs.grad, rtol=0, atol=1e-6 * float(xs.grad.abs().max()))


@pytest.mark.parametrize("activation", ["none", "leaky_relu", "elu"])
def test_abn_eval_matches_jax(activation):
    rng = np.random.RandomState(3)
    c = 6
    x = (rng.randn(2, 5, 7, c) * 2).astype(np.float32)
    weight = rng.randn(c).astype(np.float32)  # signed: exercises |w| + eps
    bias = rng.randn(c).astype(np.float32)
    mean = rng.randn(c).astype(np.float32)
    var = (rng.rand(c) + 0.5).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    ref = np.asarray(jbn.ABN(activation=activation).apply(
        variables, jnp.asarray(x), use_running_average=True))

    mod = tbn.ABN(c, activation=activation)
    mod.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias),
                         "running_mean": torch.from_numpy(mean),
                         "running_var": torch.from_numpy(var)}, strict=True)
    mod.eval()
    ours = _nhwc(mod(_nchw(x)))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_batch_norm_2d_plain_gamma_matches_jax():
    rng = np.random.RandomState(4)
    c = 3
    x = rng.randn(1, 4, 4, c).astype(np.float32)
    weight, bias = rng.randn(c).astype(np.float32), rng.randn(c).astype(np.float32)
    mean, var = rng.randn(c).astype(np.float32), (rng.rand(c) + 0.5).astype(np.float32)
    variables = {"params": {"weight": jnp.asarray(weight), "bias": jnp.asarray(bias)},
                 "batch_stats": {"mean": jnp.asarray(mean), "var": jnp.asarray(var)}}
    ref = np.asarray(jbn.BatchNorm2d().apply(variables, jnp.asarray(x),
                                             use_running_average=True))
    mod = tbn.BatchNorm2d(c)
    mod.load_state_dict({"weight": torch.from_numpy(weight), "bias": torch.from_numpy(bias),
                         "running_mean": torch.from_numpy(mean),
                         "running_var": torch.from_numpy(var)})
    ours = _nhwc(mod.eval()(_nchw(x)))
    np.testing.assert_allclose(ours, ref, atol=ATOL, rtol=0)


def test_abn_train_mode_raises_naming_roadmap():
    """Train mode used to raise until its ROADMAP item was ported; now it
    normalises with the batch statistics and moves the running ones (the
    full comparison with JAX is in test_torch_port_train_parts.py)."""
    mod = tbn.ABN(4).train()
    x = torch.arange(32, dtype=torch.float32).reshape(2, 4, 2, 2)
    z = mod(x)
    mean = x.mean(dim=(0, 2, 3))
    np.testing.assert_allclose(z.mean(dim=(0, 2, 3)).detach().numpy(), 0.0, atol=1e-5)
    np.testing.assert_allclose(mod.running_mean.numpy(), 0.1 * mean.numpy(), rtol=1e-6)
