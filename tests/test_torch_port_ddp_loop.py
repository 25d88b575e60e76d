"""Dropout on, two steps a chunk: the 4-rank chunk against the port's
one-process chunk at the global batch 8.

Port against port, because dropout masks cannot cross frameworks
(tests/test_composite_step_oracle.py:29): every uniform (the DSN and PSP
`Dropout2d` masks, the GP's α) is drawn at the global batch's shape from the
same seeded generator on every rank, and the rank keeps its rows, so the
ranks' masks are the one-process masks and the generators stay in step.
The chunk runs through `make_train_loop(cfg, 2, group)` (eagerly on the
CPU), from the port's seeded initial weights, f32.

The metrics and the parameters after the chunk agree within 1e-5 relative
(tests/ddp_cases.py sizes the step for that). The momentum buffers are the
raw gradient sums, which f32 determines only to their summation order: each
model's buffers, taken as one vector, agree within 2e-3 relative L2
(measured 5.6e-4 for G and 1.4e-4 for D); a tensor whose gradient nearly
cancels (a conv bias under a BN) differs by its whole size on its own.
"""

import numpy as np
import pytest
import torch

import ddp_cases

REL = 1e-5
MOMENTUM_REL_L2 = 2e-3


@pytest.fixture(scope="module")
def run():
    images, labels = ddp_cases.step_batch(7, steps=2)
    payload = {"cfg": ddp_cases.cfg_kwargs("wgan-gp"), "images": images, "labels": labels,
               "drop_rate": 0.1, "unroll": 2, "draw_seed": 11}
    ranks = ddp_cases.launch_step(payload)
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    try:
        one = ddp_cases.run_step(payload)
    finally:
        torch.set_num_threads(n)
    return ranks, one


def test_ranks_hold_identical_state(run):
    ddp_cases.assert_ranks_identical(run[0])


def test_chunk_equals_the_one_process_chunk(run):
    ranks, one = run
    for k, v in one["metrics"].items():
        np.testing.assert_allclose(ranks[0]["metrics"][k], v, rtol=REL, atol=1e-6, err_msg=k)
    for part in ("student", "disc"):
        for k, v in one[part].items():
            np.testing.assert_allclose(ranks[0][part][k], v, rtol=REL, atol=1e-6,
                                       err_msg=f"{part}:{k}")
    for part in ("g_mom", "d_mom"):
        a = np.concatenate([t.ravel() for t in ranks[0][part]])
        b = np.concatenate([t.ravel() for t in one[part]])
        assert np.linalg.norm(a - b) <= MOMENTUM_REL_L2 * np.linalg.norm(b), part
