"""A run of each cell kind with the timed path broken underneath comes out
not correct, and the sound run correct: the harness's whole run (its look
for a card skipped, the program in float32 on the CPU at toy sizes) with
the cell's own limits.

Faults: a train step that leaves the state unchanged; half of each batch
left out, the mean taken over the rest; the val sweep's class maps altered
where the kernel produces them. The control (the reference in the
precision below the configuration's, in the program's place) is
`test_bench_control.py`'s."""

from __future__ import annotations

import pytest
import torch

from benchmark import run as bench_run
from benchmark.drivers import eval as eval_driver
from benchmark.drivers import train
from benchmark.tests.conftest import toy_cell

SEED = 2 ** 31 + 4099


def _verdict(cell, rec):
    out, checks = bench_run.result(cell, rec, False)
    return out["correct"], checks


@pytest.fixture(scope="module")
def train_cell():
    return toy_cell("psp_r18_kd.train_b8_512")


def test_sound_train_run_is_correct(train_cell, cpu_card):
    rec = train.run(train_cell, SEED, 1.0, False, "cpu")
    correct, checks = _verdict(train_cell, rec)
    assert correct, checks


def test_state_left_unchanged_is_caught(train_cell, cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.training import train_step

    monkeypatch.setattr(train_step, "sgd_update", lambda *a, **k: None)
    rec = train.run(train_cell, SEED, 1.0, False, "cpu")
    correct, checks = _verdict(train_cell, rec)
    assert not correct, checks


def test_half_the_batch_is_caught(train_cell, cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.training import train_step

    call = train_step.TrainLoop.__call__

    def half(self, state, images_k, labels_k, n_valid, *args, **kwargs):
        n = images_k.shape[1] // 2
        return call(self, state, images_k[:, :n], labels_k[:, :n], n_valid, *args, **kwargs)

    monkeypatch.setattr(train_step.TrainLoop, "__call__", half)
    rec = train.run(train_cell, SEED, 1.0, False, "cpu")
    correct, checks = _verdict(train_cell, rec)
    assert not correct, checks


def test_val_sweep_sound_and_altered(cpu_card, monkeypatch):
    from structure_knowledge_distillation_tpu_torch.training import evaluate

    cell = toy_cell("psp_r18_kd.val_1024x2048")
    rec = eval_driver.run(cell, SEED, 1.0, False, "cpu")
    correct, checks = _verdict(cell, rec)
    assert correct, checks
    kernel = evaluate.upsampled_argmax

    def altered(logits, out_size):
        pred = kernel(logits, out_size)
        pred[..., : out_size[1] // 8] = (pred[..., : out_size[1] // 8] + 1) % logits.shape[1]
        return pred

    monkeypatch.setattr(evaluate, "upsampled_argmax", altered)
    rec = eval_driver.run(cell, SEED, 1.0, False, "cpu")
    correct, checks = _verdict(cell, rec)
    assert not correct, checks


def test_reference_draws_follow_the_generator():
    """The reference's uniforms are the generator's, in the order the step
    draws them: the same seed gives the same draws on both sides."""
    from benchmark import checks

    draws = checks._draws(seed=7)
    g = torch.Generator().manual_seed(7)
    for shape in ((8, 128, 1, 1), (8, 128, 1, 1), (8, 1, 1, 1)):
        assert torch.equal(draws(shape), torch.rand(shape, generator=g))
