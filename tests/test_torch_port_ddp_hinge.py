"""The data-parallel step of tests/test_torch_port_ddp_step.py with the
hinge adversarial loss (λ_pi 10): the rank shares of Pi (×1, a sum over the
batch), of Pa and of the hinge G and D terms (×1/world, means over the
batch) and of the CE (the rank's sum over the global valid count) carry the
step; scaling every term by 1/world instead, as DistributedDataParallel's
gradient averaging does, fails this case and the wgan-gp one.
"""

import pytest

import ddp_cases


@pytest.fixture(scope="module")
def run():
    payload, jax_metrics, jax_student, jax_disc = ddp_cases.jax_reference("hinge",
                                                                          lambda_pi=10.0)
    return ddp_cases.launch_step(payload), payload, jax_metrics, jax_student, jax_disc


def test_ranks_hold_identical_state(run):
    ddp_cases.assert_ranks_identical(run[0])


def test_step_matches_the_jax_sharded_step(run):
    results, payload, jax_metrics, jax_student, jax_disc = run
    ddp_cases.assert_step_matches_jax(results[0], payload, jax_metrics, jax_student, jax_disc)
