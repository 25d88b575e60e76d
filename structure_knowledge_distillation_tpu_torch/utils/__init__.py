import logging

import torch.nn as nn

from structure_knowledge_distillation_tpu_torch.utils.logging_utils import log_init
from structure_knowledge_distillation_tpu_torch.utils.metrics_writer import MetricsWriter, save_args


def count_params(module: nn.Module) -> int:
    """Total parameter count (reference print_model_parm_nums,
    utils/utils.py:164-168), the JAX `count_params` of the module's `params`
    tree: `parameters()` only. BN running statistics and the spectral u/v
    are buffers here and `batch_stats`/`spectral` collections in JAX, so
    neither package counts them; an SNConv's `weight_bar` is the JAX kernel
    leaf."""
    return int(sum(p.numel() for p in module.parameters()))


def log_param_count(module: nn.Module, name: str) -> int:
    n = count_params(module)
    logging.getLogger(__name__).info("%s: Number of params: %.2fM", name, n / 1e6)
    return n


__all__ = ["log_init", "MetricsWriter", "save_args", "count_params", "log_param_count"]
