"""The entry points with `--num-data-shards 2` on the CPU (two gloo ranks).

  * `cli.train` on synthetic 256² crops (full-width R18 student, a
    one-block-per-stage teacher, global batch 2, one sample a rank): the
    command spawns its ranks, trains, evaluates sharded and writes one
    checkpoint (rank 0); a second leg resumes from it on every rank, and a
    SIGTERM to rank 1 alone stops both ranks at the same step with one
    `latest/` save, which a one-process trainer then resumes;
  * `cli.eval --num-data-shards 2` prints the mIoU of `--num-data-shards 1`;
    in a mode the sharded sweep does not take (`--whole false`) the flag is
    ignored with the JAX CLI's warning;
  * the mesh axes the port does not have still raise, naming ROADMAP "Not
    ported", and a global batch that does not split raises.
"""

import json
import logging
import os
import re

import pytest
import torch

import ddp_cases
from structure_knowledge_distillation_tpu_torch.cli import eval as port_eval_cli
from structure_knowledge_distillation_tpu_torch.cli import train as port_cli
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.parallel import launch
from structure_knowledge_distillation_tpu_torch.training.trainer import KDTrainer

TRAIN = ["--data-set", "synthetic", "--input-size", "256,256", "--batch-size", "2",
         "--teacher-layers", "1,1,1,1", "--imsize-for-adv", "33", "--device", "cpu",
         "--log-every", "1", "--eval-every", "2", "--num-data-shards", "2"]


def _steps(log_dir, key):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [r["step"] for r in map(json.loads, f) if key in r]


def test_cli_train_two_ranks_checkpoint_resume_and_sigterm(tmp_path, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one torch thread in each spawned rank
    paths = ["--snapshot-dir", str(tmp_path / "snap"), "--S_ckpt_path", str(tmp_path / "none")]
    best = port_cli.main(TRAIN + paths + ["--num-steps", "2", "--log-path",
                                          str(tmp_path / "log1")])
    assert 0.0 <= best <= 1.0
    assert _steps(tmp_path / "log1", "g_loss") == [1, 2]
    assert _steps(tmp_path / "log1", "val_mean_iu") == [2]
    assert len(list((tmp_path / "snap").glob("CS_scenes_2_*.pth"))) == 1
    latest = tmp_path / "snap" / "latest"
    assert os.listdir(latest) == ["step_00000002.pth"]

    # leg 2: both ranks resume from step 2; rank 1 alone gets SIGTERM after
    # step 4, and both stop there with one save
    argv = TRAIN + paths + ["--num-steps", "8", "--S_resume", "true",
                            "--log-path", str(tmp_path / "log2")]
    launch(ddp_cases.rank_cli_sigterm, 2, argv, 1, 4, timeout=600)
    assert _steps(tmp_path / "log2", "g_loss") == [3, 4]
    assert sorted(os.listdir(latest)) == ["step_00000002.pth", "step_00000004.pth"]

    one = KDTrainer(TrainConfig(data_set="synthetic", input_size=(256, 256), batch_size=2,
                                teacher_layers=(1, 1, 1, 1), imsize_for_adv=33, device="cpu",
                                snapshot_dir=str(tmp_path / "snap")))
    assert one.try_resume() == 4


def _eval_args(tmp_path):
    from test_torch_port_eval import _fake_cityscapes

    lst = _fake_cityscapes(str(tmp_path), n=3)
    return ["--data-dir", str(tmp_path), "--data-list", lst, "--eval-size", "64,128",
            "--device", "cpu"]


def test_cli_eval_two_ranks_equals_one(tmp_path, capsys, caplog, monkeypatch):
    monkeypatch.setenv("OMP_NUM_THREADS", "1")  # one torch thread in each spawned rank
    base = _eval_args(tmp_path)
    one = port_eval_cli.main(base)
    out_one = capsys.readouterr().out
    two = port_eval_cli.main(base + ["--num-data-shards", "2"])
    out_two = capsys.readouterr().out
    assert two == one
    assert re.search(r"meanIU: .*", out_two).group(0) == re.search(r"meanIU: .*", out_one).group(0)
    with caplog.at_level(logging.WARNING):
        port_eval_cli.main(base + ["--num-data-shards", "2", "--whole", "false",
                                   "--tile-size", "48,48"])
    assert "shard flags ignored" in caplog.text


@pytest.mark.parametrize("flag", ["--num-model-shards", "--num-slices", "--num-spatial-shards"])
def test_unported_mesh_axes_still_raise(flag):
    with pytest.raises(NotImplementedError, match="ROADMAP 'Not ported'"):
        TrainConfig.from_args(TRAIN + [flag, "2"])


def test_cli_eval_spatial_shards_still_raise(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP 'Not ported'"):
        port_eval_cli.main(["--data-dir", str(tmp_path), "--device", "cpu",
                            "--num-spatial-shards", "2"])


def test_an_indivisible_batch_raises():
    with pytest.raises(ValueError, match="not divisible"):
        port_cli.main(TRAIN + ["--batch-size", "3"])
    with pytest.raises(ValueError, match="not divisible"):
        TrainConfig(batch_size=8, num_data_shards=3)


def test_a_launched_rank_that_fails_fails_the_launch():
    """A rank that raises fails `launch` with its traceback; the other rank,
    waiting in a collective for it, is stopped."""
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        launch(ddp_cases.rank_fails, 2, 1, timeout=120)


def test_without_shards_no_group_is_joined():
    from structure_knowledge_distillation_tpu_torch.parallel import join_group

    assert join_group(1, "cpu") is None
    assert not torch.distributed.is_initialized()
