"""OHEM under data parallelism: the threshold of the global batch and the
step against the JAX step on a 4-device `data` mesh.

OHEM's threshold is the k-th smallest ground-truth probability of the whole
batch (JAX `losses/ohem.py:63-80`). Each rank gathers the ranks'
down-sampled probabilities and all-reduces the valid count, so the
threshold is the one-process threshold on every rank, and its CE is its
kept sum over the global kept count. With rank 0's labels 90 % ignored, a
per-rank threshold would take rank 0's k ≥ valid branch (1.0) while the
global one is an order statistic: `ohem_thresh` 0.1 and k = 1000 put the
threshold among the random model's probabilities, so the kept set, and the
step, depend on it.
"""

import numpy as np
import pytest
import torch

import ddp_cases

KW = dict(ignore_index=255, thresh=0.1, min_kept=64000)


def _probe():
    """Logits (8, 7, 256, 256) of a fairly confident model and the step
    case's labels: most ground-truth probabilities lie near the order
    statistic k = 1000 of the ~6350 valid down-sampled pixels."""
    _, labels = ddp_cases.step_batch(42)
    rng = np.random.RandomState(3)
    logits = (2.0 * rng.randn(ddp_cases.BATCH, ddp_cases.CLASSES, 256, 256)).astype(np.float32)
    return logits, labels[0]


@pytest.fixture(scope="module")
def run():
    from structure_knowledge_distillation_tpu_torch.parallel import launch

    payload, jax_metrics, jax_student, jax_disc = ddp_cases.jax_reference(
        "wgan-gp", ohem=True, ohem_thresh=KW["thresh"], ohem_min_kept=KW["min_kept"])
    logits, labels = _probe()
    results = launch(ddp_cases.rank_ohem, ddp_cases.WORLD, payload, logits, labels, KW,
                     timeout=300)
    return results, payload, jax_metrics, jax_student, jax_disc


def test_threshold_is_the_one_process_threshold(run):
    from structure_knowledge_distillation_tpu_torch.losses.ohem import (
        ohem_cross_entropy,
        ohem_threshold,
    )

    logits, labels = map(torch.from_numpy, _probe())
    one = float(ohem_threshold(logits, labels, **KW))
    per_rank0 = float(ohem_threshold(logits[:2], labels[:2], **KW))
    assert per_rank0 == 1.0 and one < 1.0  # the case tells the two apart
    results = run[0]
    for res in results:
        assert abs(res["threshold"] - one) <= 1e-6
    loss = float(ohem_cross_entropy(logits, labels, **KW))
    np.testing.assert_allclose(sum(r["ohem_share"] for r in results), loss, rtol=1e-5)


def test_ranks_hold_identical_state(run):
    ddp_cases.assert_ranks_identical(run[0])


def test_step_matches_the_jax_sharded_step(run):
    results, payload, jax_metrics, jax_student, jax_disc = run
    ddp_cases.assert_step_matches_jax(results[0], payload, jax_metrics, jax_student, jax_disc)
