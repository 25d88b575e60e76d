"""The port's OHEM task loss vs the JAX `losses/ohem.py` on the same inputs.

`ohem_cross_entropy` (full-resolution logits) and `criterion_ohem_dsn`
(low-resolution heads upsampled to the labels) over the cases that take each
branch of the threshold: k = min_kept // 64 below the valid count of the
1/8 grid, k at or above it (threshold 1.0: every valid pixel kept),
min_kept 0 (the threshold stays `thresh`) and mostly-ignored labels. The
loss agrees at rtol 1e-5 and the gradient w.r.t. the logits within 1e-5 of
its largest entry: both sides pick the same pixels (one f32 softmax each,
the same order statistic) and differ only in the order of f32 sums.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.losses import ohem as jax_ohem
from structure_knowledge_distillation_tpu_torch.losses import ohem

LOSS_RTOL = 1e-5
GRAD_REL = 1e-5
N, C, H, W = 2, 5, 48, 64  # the 1/8 grid is 6×8: 96 downsampled pixels


def _case(seed, ignored, h=H, w=W, scale=2.0, confidence=4.0):
    """Labels in blocks and the logits of a fairly confident model: the label's class gets
    `confidence` on top of N(0, scale²) noise, so most ground-truth
    probabilities lie above 0.7 and the k-th smallest sets the threshold."""
    rng = np.random.RandomState(seed)
    logits = (scale * rng.randn(N, h, w, C)).astype(np.float32)
    # classes in 8×8 blocks, as a scene's regions: the 1/8 grid's bilinear
    # probabilities then mostly read one class
    labels = rng.randint(0, C, (N, H // 8, W // 8)).repeat(8, 1).repeat(8, 2).astype(np.int32)
    if (h, w) == (H, W):
        np.put_along_axis(logits, labels[..., None],
                          np.take_along_axis(logits, labels[..., None], -1) + confidence, -1)
    labels[rng.rand(N, H, W) < ignored] = 255
    return logits, labels


CASES = {
    # (seed, ignored share, min_kept): k = min_kept // 64 against ~96 valid
    "k<valid": (0, 0.1, 64 * 45),
    "k<valid-seed1": (1, 0.3, 64 * 50),
    "k>=valid": (2, 0.1, 64 * 200),
    "min_kept0": (3, 0.1, 0),
    "mostly-ignored": (4, 0.95, 64 * 20),
    "k<valid-mostly-ignored": (5, 0.9, 64 * 3),
}


def _torch(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2))).requires_grad_(True)


@pytest.mark.parametrize("name", list(CASES))
def test_ohem_cross_entropy_matches_jax(name):
    seed, ignored, min_kept = CASES[name]
    logits, labels = _case(seed, ignored)

    def jloss(x):
        return jax_ohem.ohem_cross_entropy(x, jnp.asarray(labels), 255, 0.7, min_kept)

    want, jgrad = jax.value_and_grad(jloss)(jnp.asarray(logits))
    x = _torch(logits)
    got = ohem.ohem_cross_entropy(x, torch.from_numpy(labels), 255, 0.7, min_kept)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    jgrad = np.asarray(jgrad)
    np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), jgrad, rtol=0,
                               atol=GRAD_REL * float(np.abs(jgrad).max()) + 1e-12)


@pytest.mark.parametrize("name", ["k<valid", "k>=valid", "min_kept0", "mostly-ignored"])
def test_criterion_ohem_dsn_matches_jax(name):
    """Low-resolution main and aux heads (12×16, ×4 to the 48×64 labels)."""
    seed, ignored, min_kept = CASES[name]
    main, labels = _case(seed, ignored, 12, 16)
    aux, _ = _case(seed + 10, ignored, 12, 16)

    def jloss(m, a):
        return jax_ohem.criterion_ohem_dsn((m, a), jnp.asarray(labels), 255, 0.7, min_kept)

    want, (jg_main, jg_aux) = jax.value_and_grad(jloss, argnums=(0, 1))(jnp.asarray(main),
                                                                      jnp.asarray(aux))
    xm, xa = _torch(main), _torch(aux)
    got = ohem.criterion_ohem_dsn((xm, xa), torch.from_numpy(labels), 255, 0.7, min_kept)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=LOSS_RTOL)
    for x, g in ((xm, jg_main), (xa, jg_aux)):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy().transpose(0, 2, 3, 1), g, rtol=0,
                                   atol=GRAD_REL * float(np.abs(g).max()) + 1e-12)


def test_threshold_branches():
    """The threshold of each branch: never below `thresh` with k < valid;
    exactly 1.0 with k ≥ valid; exactly `thresh` with min_kept 0. The
    selection is over the whole batch: the kept pixels of one image depend
    on the other's."""
    logits, labels = _case(0, 0.1)
    x, lab = _torch(logits).detach(), torch.from_numpy(labels)
    t = ohem.ohem_threshold(x, lab, 255, 0.7, 64 * 45)
    assert t.dtype == torch.float32 and t.dim() == 0 and np.float32(0.7) < float(t) < 1.0
    assert float(ohem.ohem_threshold(x, lab, 255, 0.7, 64 * 200)) == 1.0
    assert float(ohem.ohem_threshold(x, lab, 255, 0.3, 0)) == np.float32(0.3)
    # whole batch: the threshold of image 0 alone differs from the pair's
    t0 = ohem.ohem_threshold(x[:1], lab[:1], 255, 0.0, 64 * 20)
    t_both = ohem.ohem_threshold(x, lab, 255, 0.0, 64 * 20)
    assert float(t0) != float(t_both)


@pytest.mark.parametrize("n,out", [(48, 6), (64, 8), (360, 45), (7, 1), (5, 0)])
def test_zoom0_indices_match_jax(n, out):
    got = ohem._zoom0_indices(n, out, "cpu").numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_ohem._zoom0_indices(n, out)))
