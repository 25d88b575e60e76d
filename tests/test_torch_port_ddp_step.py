"""One data-parallel step of the port over 4 gloo ranks against the JAX step
on a 4-device `data` mesh (Pi+Pa+Ho wgan-gp, unfused ABN).

Each rank runs the port's step on its 2 rows of the global batch 8 through
the port's launcher; the JAX step is jitted on `make_mesh(num_data=4)` at
batch 8 from the same weights, the GP's α fed to the port (each rank its
rows). D runs in preprocess mode 1, so its BatchNorm2d syncs under the GP's
double backward. The labels ignore ~90 % of rank 0's pixels and none of the
others': a per-rank CE mean would differ from the global one. The cases and
tolerances are in tests/ddp_cases.py.
"""

import pytest

import ddp_cases


@pytest.fixture(scope="module")
def run():
    payload, jax_metrics, jax_student, jax_disc = ddp_cases.jax_reference("wgan-gp")
    return ddp_cases.launch_step(payload), payload, jax_metrics, jax_student, jax_disc


def test_ranks_hold_identical_state(run):
    ddp_cases.assert_ranks_identical(run[0])


def test_step_matches_the_jax_sharded_step(run):
    results, payload, jax_metrics, jax_student, jax_disc = run
    ddp_cases.assert_step_matches_jax(results[0], payload, jax_metrics, jax_student, jax_disc)
