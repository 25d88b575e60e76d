from structure_knowledge_distillation_tpu_torch.ops.batch_norm import (
    ABN,
    BatchNorm2d,
    abn_normalize,
    abn_train,
)
from structure_knowledge_distillation_tpu_torch.ops.pooling import (
    adaptive_avg_pool_2d,
    max_pool_2d,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import (
    interp_matrix_align_corners,
    resize_bilinear_align_corners,
)
from structure_knowledge_distillation_tpu_torch.ops.spectral import SNConv
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    upsampled_argmax,
    upsampled_argmax_plain,
)
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import (
    upsampled_ce_loss,
    upsampled_ce_loss_dsn,
    upsampled_ce_loss_dsn_plain,
    upsampled_ce_loss_plain,
)

__all__ = [
    "ABN",
    "BatchNorm2d",
    "abn_normalize",
    "abn_train",
    "SNConv",
    "adaptive_avg_pool_2d",
    "max_pool_2d",
    "interp_matrix_align_corners",
    "resize_bilinear_align_corners",
    "upsampled_argmax",
    "upsampled_argmax_plain",
    "upsampled_ce_loss",
    "upsampled_ce_loss_dsn",
    "upsampled_ce_loss_dsn_plain",
    "upsampled_ce_loss_plain",
]
