from structure_knowledge_distillation_tpu_torch.utils.logging_utils import log_init
from structure_knowledge_distillation_tpu_torch.utils.metrics_writer import MetricsWriter, save_args

__all__ = ["log_init", "MetricsWriter", "save_args"]
