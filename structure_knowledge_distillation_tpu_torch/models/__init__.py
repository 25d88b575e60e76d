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

__all__ = [
    "BASIC",
    "BOTTLENECK",
    "BasicBlock",
    "Bottleneck",
    "PSPModule",
    "ResPSPNet",
    "student_model",
    "teacher_model",
]
