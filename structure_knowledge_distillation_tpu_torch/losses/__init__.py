from structure_knowledge_distillation_tpu_torch.losses.adversarial import (
    adv_loss_for_d,
    adv_loss_for_g,
    gp_alpha,
    gradient_penalty,
)
from structure_knowledge_distillation_tpu_torch.losses.distill import (
    pairwise_affinity_loss,
    pixel_wise_kl,
    sim_dis_compute,
    similarity_gram,
)
from structure_knowledge_distillation_tpu_torch.losses.ohem import (
    criterion_ohem_dsn,
    ohem_cross_entropy,
)
from structure_knowledge_distillation_tpu_torch.losses.task import (
    criterion_dsn,
    criterion_dsn_fused,
    cross_entropy_ignore,
)

__all__ = [
    "adv_loss_for_d",
    "adv_loss_for_g",
    "criterion_dsn",
    "criterion_dsn_fused",
    "criterion_ohem_dsn",
    "cross_entropy_ignore",
    "gp_alpha",
    "gradient_penalty",
    "ohem_cross_entropy",
    "pairwise_affinity_loss",
    "pixel_wise_kl",
    "sim_dis_compute",
    "similarity_gram",
]
