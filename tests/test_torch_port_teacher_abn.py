"""The frozen teacher's ABNs in `KDTrainer` (`training/trainer.py`).

`teacher_bn_fused` decides by the device's type: a CUDA device fuses the
teacher's ABNs (the eval kernel K6), the CPU does not. A CPU trainer's
teacher, student and discriminator hold unfused ABNs only, so the CPU parity
runs against the JAX package see the unfused path's numbers, and the
counter `teacher.fused_abn` reads 0 while recording. The full-depth R101
teacher has 112 ABNs, each of which takes K6 on the card. The card's side
(the trainer's teacher fused there, its forward against the unfused one,
a replayed chunk against eager steps) is in `tests/test_torch_port_cuda.py`.
"""

import pytest
import torch

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import BOTTLENECK, ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops import ABN
from structure_knowledge_distillation_tpu_torch.training.trainer import (
    KDTrainer,
    _fused_abns,
    teacher_bn_fused,
)
from structure_knowledge_distillation_tpu_torch.utils import spans


@pytest.mark.parametrize("device,fused", [
    ("cuda", True), ("cuda:1", True), (torch.device("cuda", 0), True),
    ("cpu", False), (torch.device("cpu"), False),
])
def test_teacher_bn_fused_follows_the_device_type(device, fused):
    assert teacher_bn_fused(device) is fused


def test_cpu_trainer_keeps_every_abn_unfused(tmp_path):
    cfg = TrainConfig(data_set="synthetic", batch_size=1, input_size=(256, 256),
                      teacher_layers=(1, 1, 1, 1), imsize_for_adv=33, device="cpu",
                      log_path="", snapshot_dir=str(tmp_path / "snap"),
                      S_ckpt_path=str(tmp_path / "student"), seed=3)
    spans.start()
    try:
        trainer = KDTrainer(cfg)
    finally:
        record = spans.stop()
    assert record.counters["teacher.fused_abn"] == trainer.teacher_fused_abn == 0
    teacher_abns = [m for m in trainer.teacher.modules() if isinstance(m, ABN)]
    assert len(teacher_abns) == 25  # stem 3, 4 blocks of 3 + 4 downsamples, PSP 5, DSN 1
    for model in (trainer.teacher, trainer.student, trainer.discriminator):
        abns = [m for m in model.modules() if isinstance(m, ABN)]
        assert abns and not any(m.fused for m in abns)


def test_the_r101_teacher_fuses_112_abns():
    teacher = ResPSPNet(BOTTLENECK, (3, 4, 23, 3), 19, bn_fused=teacher_bn_fused("cuda"))
    assert _fused_abns(teacher) == 112
    assert _fused_abns(ResPSPNet(BOTTLENECK, (3, 4, 23, 3), 19,
                                 bn_fused=teacher_bn_fused("cpu"))) == 0
