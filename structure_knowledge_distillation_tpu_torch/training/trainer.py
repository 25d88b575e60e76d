"""KDTrainer — builds the models and optimizers, runs the train step and eval.

Counterpart of `structure_knowledge_distillation_tpu/training/trainer.py`
(reference networks/kd_model.py `NetModel` + the loop of
train_and_eval.py:20-30): model and state construction from a `TrainConfig`,
the per-step loop with metric logging every `log_every` steps, and the
reference's `should_eval` cadence through the ported `evaluate_main`.

Resume, SIGTERM handling, checkpoint saving, the profiler and the prefetcher
are ROADMAP Queue A item 6 and not ported yet (the config raises for their
options).
"""

from __future__ import annotations

import logging
import time
from typing import Iterable, Mapping, Optional

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.models import BASIC, BOTTLENECK, ResPSPNet
from structure_knowledge_distillation_tpu_torch.models.sagan import Discriminator
from structure_knowledge_distillation_tpu_torch.training.checkpoint import (
    load_reference_state_dict,
)
from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step

__all__ = ["KDTrainer"]

log = logging.getLogger(__name__)

_DTYPES = {"bfloat16": torch.bfloat16, "float32": None}


def _as_tensors(state_dict: Mapping) -> dict:
    return {k: torch.as_tensor(np.asarray(v) if not isinstance(v, torch.Tensor) else v)
            for k, v in state_dict.items()}


class KDTrainer:
    """Teacher, student and discriminator on `cfg.device`, with their optimizers.

    `teacher_state`, `student_state` and `d_state` are state dicts under the
    reference's torch names (a released `.pth`, or the JAX package's
    `export_torch_*`). A missing teacher is all zeros, with the JAX trainer's
    warning; a missing student or discriminator keeps its seeded random
    init, drawn from `torch.Generator().manual_seed(cfg.seed)` (student
    first, then D). The same generator then draws the dropout masks and the
    GP α of every step."""

    def __init__(self, cfg: TrainConfig, teacher_state: Optional[Mapping] = None,
                 student_state: Optional[Mapping] = None, d_state: Optional[Mapping] = None):
        self.cfg = cfg
        device = torch.device(cfg.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("no CUDA device on this host; pass --device cpu")
        self.device = device
        dtype = _DTYPES[cfg.compute_dtype]

        self.teacher = ResPSPNet(BOTTLENECK, tuple(cfg.teacher_layers), cfg.classes_num,
                                 device=device, dtype=dtype,
                                 generator=torch.Generator().manual_seed(cfg.seed))
        if teacher_state is None:
            with torch.no_grad():
                for t in list(self.teacher.parameters()) + list(self.teacher.buffers()):
                    t.zero_()
            log.warning("teacher initialized with zeros — load a real checkpoint "
                        "for distillation (cfg.T_ckpt_path)")
        else:
            load_reference_state_dict(self.teacher, teacher_state)
        self.teacher.requires_grad_(False)

        self.generator = torch.Generator().manual_seed(cfg.seed)
        self.student = ResPSPNet(BASIC, (2, 2, 2, 2), cfg.classes_num, device=device,
                                 dtype=dtype, generator=self.generator)
        if student_state is not None:
            load_reference_state_dict(self.student, student_state)
        self.discriminator = Discriminator(
            cfg.classes_num, preprocess_mode=cfg.preprocess_gan_mode,
            image_size=cfg.imsize_for_adv, conv_dim=cfg.adv_conv_dim, dtype=dtype,
            device=device, generator=self.generator)
        if d_state is not None:
            self.discriminator.load_state_dict(_as_tensors(d_state), strict=True)

        self.state = KDTrainState(
            teacher=self.teacher, student=self.student, discriminator=self.discriminator,
            g_opt=make_sgd(self.student.parameters(), cfg.lr_g, cfg.momentum,
                           cfg.weight_decay),
            d_opt=make_sgd(self.discriminator.parameters(), cfg.lr_d, cfg.momentum,
                           cfg.weight_decay),
            g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
            d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power),
        )
        self.train_step = make_train_step(cfg)
        # (step, {metric: float}) at every logged step
        self.history: list = []

    def fit(self, train_iter: Iterable, val_loader=None, eval_out_size=(1024, 2048)) -> float:
        """One train step per batch of `train_iter` ((images NHWC, labels NHW,
        ...) numpy batches); logs every `log_every` steps and evaluates on
        the `should_eval` cadence. Returns the best val mean IU."""
        cfg = self.cfg
        best = cfg.best_mean_IU
        t_last = time.time()
        steps_since_log = 0
        for batch in train_iter:
            step = self.state.step + 1
            images = torch.from_numpy(np.ascontiguousarray(batch[0])).to(self.device)
            images = images.permute(0, 3, 1, 2).contiguous()
            labels = torch.from_numpy(np.asarray(batch[1])).to(self.device)
            metrics = self.train_step(self.state, images, labels, self.generator)
            steps_since_log += 1

            if step % cfg.log_every == 0:
                m = {k: float(v) for k, v in metrics.items()}
                dt = time.time() - t_last
                ips = steps_since_log * cfg.batch_size / max(dt, 1e-9)
                t_last = time.time()
                steps_since_log = 0
                log.info("step:%5d G_lr:%.6f G_loss:%.5f (mc:%.5f pi:%.5f pa:%.5f) "
                         "D_lr:%.6f D_loss:%.5f img/s:%.2f",
                         step, self.state.g_sched(step), m["g_loss"], m["mc_loss"],
                         m.get("pi_loss", 0.0), m.get("pa_loss", 0.0),
                         self.state.d_sched(step), m["d_loss"], ips)
                self.history.append((step, m))

            if val_loader is not None and cfg.should_eval(step):
                loader = val_loader() if callable(val_loader) else val_loader
                mean_iu, iu_array = self.evaluate(loader, eval_out_size)
                log.info("[val] step %d mean_IU: %.6f IU_array: %s", step, mean_iu,
                         np.array2string(iu_array, precision=4))
                best = max(best, mean_iu)
        return best

    def evaluate(self, val_loader: Iterable, out_size=(1024, 2048)):
        """The student's whole-image val sweep; returns (mean_IU, IU_array)."""
        self.student.eval()
        try:
            mean_iu, iu_array, _ = evaluate_main(
                self.student, val_loader, self.cfg.classes_num, out_size=tuple(out_size),
                ignore_label=self.cfg.ignore_label, device=self.device)
        finally:
            self.student.train()
        return mean_iu, iu_array
