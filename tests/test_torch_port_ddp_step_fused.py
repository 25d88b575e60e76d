"""The data-parallel step of tests/test_torch_port_ddp_step.py with the
fused ABN (`bn_fused=True`) in the port's teacher and student: the fused
path's plain versions of K6–K8 on the CPU, with the statistics all-reduced
before K6 and K7's sums before K8. The reference is the JAX step on the
4-device `data` mesh with its unfused ABN, the same function
(tests/ddp_cases.py::jax_reference says why).
"""

import pytest

import ddp_cases


@pytest.fixture(scope="module")
def run():
    payload, jax_metrics, jax_student, jax_disc = ddp_cases.jax_reference("wgan-gp")
    payload["bn_fused"] = True
    return ddp_cases.launch_step(payload), payload, jax_metrics, jax_student, jax_disc


def test_ranks_hold_identical_state(run):
    ddp_cases.assert_ranks_identical(run[0])


def test_step_matches_the_jax_sharded_step(run):
    results, payload, jax_metrics, jax_student, jax_disc = run
    ddp_cases.assert_step_matches_jax(results[0], payload, jax_metrics, jax_student, jax_disc)
