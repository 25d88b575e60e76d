from structure_knowledge_distillation_tpu_torch.models.espnet import ESPNetC
from structure_knowledge_distillation_tpu_torch.models.fold import abn_conv_pairs, fold_bn_state_dict
from structure_knowledge_distillation_tpu_torch.models.resnet_pspnet import (
    BASIC,
    BOTTLENECK,
    BasicBlock,
    Bottleneck,
    PSPModule,
    ResPSPNet,
    student_model,
    teacher_model,
)
from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator, SelfAttention

__all__ = [
    "BASIC",
    "BOTTLENECK",
    "BasicBlock",
    "Bottleneck",
    "Discriminator",
    "ESPNetC",
    "PSPModule",
    "ResPSPNet",
    "SelfAttention",
    "abn_conv_pairs",
    "fold_bn_state_dict",
    "student_model",
    "teacher_model",
]
