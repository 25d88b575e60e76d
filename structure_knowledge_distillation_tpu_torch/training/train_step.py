"""The KD train step: teacher forward, 4-term G loss, D step with WGAN-GP,
and the multi-step loop that replays `unroll` steps as one CUDA graph.

Counterpart of `structure_knowledge_distillation_tpu/training/train_step.py`
(reference `NetModel.optimize_parameters`, networks/kd_model.py:119-173), in
the same order and with the same detach points:

  1. the teacher forward in eval mode under `no_grad`;
  2. the student train forward (the R18 `ResPSPNet` or the ESPNet-C
     `ESPNetC`); the G loss is the task loss + λ_pi·Pi + λ_pa·Pa +
     λ_d·AdvG, where AdvG applies D in train mode to the student's logits
     with gradient. The task loss is chosen as in the JAX step: OHEM
     (`criterion_ohem_dsn`) with `cfg.ohem`, else the fused DSN
     cross-entropy (the upsampled-CE kernels on the card: K4/K5 when the two
     heads agree in shape, as the R18 student's do; K2/K3 once per head when
     they differ, as ESPNet-C's stride-8 and stride-4 heads do), else the
     materialised one. A student whose stride-8 grid differs from the
     teacher's (ESPNet-C floors where the PSPNet stem ceils) gets the
     teacher's logits and feature resized to its grid first;
  3. the G gradients are taken with `torch.autograd.grad` w.r.t. the student
     parameters only: D's parameters get no gradient from the G loss, which
     the JAX step also throws away; then the G SGD update;
  4. D loss = λ_d·adv(D(S), D(T)) (+ λ_d·λ_gp·GP for wgan-gp) on the
     detached teacher and student logits, D's parameters as they were before
     the step; then the D SGD update.

D's running statistics and spectral u/v advance at each D application, in
order: G-adv, D(T), D(S), GP (4 per step with wgan-gp, 3 with hinge). The
modules are updated in place; the metrics come back as detached tensors, so
a step does not wait for the device.

The teacher forward, the G loss-and-update and the D loss-and-update run
under `torch.profiler.record_function` ranges (`teacher_forward`, as the JAX
step's `jax.named_scope`s, `student_loss_and_grad` and `d_loss_and_grad`),
so a profile splits the step the same way.

Randomness: the dropout masks and the GP α are uniforms from one
`torch.Generator`, drawn on the CPU in a fixed order each step (the DSN
dropout, the PSP dropout, then α); `alpha` may be given instead, as the
parity tests do with the JAX step's α. The lr of each update is a 0-dim
tensor on the device (`train_state.sgd_update`).

`make_train_loop(cfg, unroll)` is the JAX `make_train_loop` (a `lax.scan`
over a stacked chunk): on CPU tensors it runs the chunk's valid steps
eagerly, through the code the single step runs. On the card the first full
chunk runs eagerly as well (it makes the momentum buffers, fills the
device tap and interpolation tables, builds the kernels and settles
cuDNN's choices); the next full chunk is captured as one CUDA graph of
`unroll` steps on the loop's own stream, and every full chunk after it is
one replay. Before a replay the host copies the chunk into the graph's
static inputs and writes the chunk's lr values and uniforms, drawn from the
generator in the order the eager steps draw them, into one device buffer
that the graph reads. A tail chunk (`n_valid < unroll`) runs its steps
eagerly, and the loop counts eager and replayed steps. A capture or replay
that fails raises; nothing falls back to the eager loop.

Data parallel (`group`, a process group over the ranks; the JAX step jitted
on a `data` mesh): each rank runs the step on its contiguous slice of the
global batch, and together they compute the global-batch step.
  * Every term enters the backward as the rank's share of its global value:
    the task loss as the rank's sum over the global valid count (the losses'
    `group`), Pi ×1 (a sum over the batch), Pa, the adversarial G and D
    terms and the GP ×1/world (means over the batch). The student's and D's
    ABNs sync their statistics (`ops/batch_norm.py::set_process_group`).
  * `sgd_step` sums each gradient over the ranks, as one flat buffer
    between `torch.autograd.grad` and `sgd_update`, once for G and once for
    D; the ranks then take identical updates.
  * The metrics are the all-reduced shares: the global values.
  * Every uniform is drawn at the global batch's shape from the same seeded
    generator on every rank, and the rank keeps its rows (`_RowShard`), so
    the masks and α are the one-process ones; `_HostDraws` and the loop's
    draw plan record the global shapes.
  * On the card with NCCL the collectives are captured with the rest of the
    chunk (after the eager warm-up chunk on every rank). Gloo collectives
    cannot be captured: with a gloo group the loop runs every chunk eagerly,
    by that rule, never by catching a failed capture.
Without a group the step issues no collective.
"""

from __future__ import annotations

import logging
import math
import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist
from torch.profiler import record_function

from structure_knowledge_distillation_tpu_torch.data.cityscapes import IMG_MEAN_BGR
from structure_knowledge_distillation_tpu_torch.losses import (
    adv_loss_for_d,
    adv_loss_for_g,
    criterion_dsn,
    criterion_dsn_fused,
    criterion_ohem_dsn,
    gp_alpha,
    gradient_penalty,
    pairwise_affinity_loss,
    pixel_wise_kl,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.spectral import spectral_in_place
from structure_knowledge_distillation_tpu_torch.parallel.data_parallel import (
    all_reduce_sum,
    shard_rows,
    world_of,
)
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    momentum_buffers,
    set_lr,
    sgd_update,
)

__all__ = ["make_train_step", "make_train_loop", "TrainLoop"]

log = logging.getLogger(__name__)

Metrics = Dict[str, torch.Tensor]


def _use_fused_ce(cfg) -> bool:
    """'auto' and 'true': the fused criterion, whose wrappers launch the
    kernels on CUDA tensors and take the plain versions on CPU tensors;
    'false': the materialised `criterion_dsn`."""
    flag = getattr(cfg, "fused_ce", "auto")
    if flag in (False, "false", "False"):
        return False
    if flag in (True, "true", "True", "auto"):
        return True
    raise ValueError(f"fused_ce should be auto, true or false, got {flag!r}")


class _HostDraws:
    """The uniform source of eager steps: each call draws U[0, 1) of the
    given shape on the CPU from `generator` (torch's default one when None)
    and moves it to `device`; `shapes` lists the shapes drawn, in order."""

    def __init__(self, generator: Optional[torch.Generator], device: torch.device):
        self.generator = generator
        self.device = device
        self.shapes: List[tuple] = []

    def __call__(self, shape) -> torch.Tensor:
        self.shapes.append(tuple(shape))
        return torch.rand(shape, generator=self.generator).to(self.device)


class _BufferDraws:
    """The uniform source of a captured chunk: consecutive slices of a flat
    device buffer that the host fills before each replay, drawing the
    recorded `plan` of shapes once per step."""

    def __init__(self, flat: torch.Tensor, plan: List[tuple]):
        self.flat, self.plan, self.offset, self.calls = flat, plan, 0, 0

    def __call__(self, shape) -> torch.Tensor:
        want = self.plan[self.calls % len(self.plan)] if self.plan else None
        if tuple(shape) != want:
            raise RuntimeError(f"the captured step drew a uniform of shape {tuple(shape)} "
                               f"where the eager steps drew {want}")
        n = math.prod(shape)
        out = self.flat[self.offset:self.offset + n].view(shape)
        self.offset += n
        self.calls += 1
        return out


class _RowShard:
    """The uniform source of one rank of `world`: each draw is made at the
    global batch's shape (the leading axis times `world`) from `draws`, and
    the rank keeps its rows, so the ranks' draws together are the
    one-process draws."""

    def __init__(self, draws: Callable, rank: int, world: int):
        self.draws, self.rank, self.world = draws, rank, world

    def __call__(self, shape) -> torch.Tensor:
        full = self.draws((shape[0] * self.world, *shape[1:]))
        return shard_rows(full, self.rank, self.world)


def _lr_values(state: KDTrainState, n: int) -> List[float]:
    """The n G lrs, then the n D lrs, of the next n updates."""
    steps = range(state.step, state.step + n)
    return [state.g_sched(s) for s in steps] + [state.d_sched(s) for s in steps]


def _advance(state: KDTrainState, n: int) -> None:
    """Count n updates done; the optimizers' param groups record the last lr
    (the lr `state_dict` carries)."""
    set_lr(state.g_opt, state.g_sched(state.step + n - 1))
    set_lr(state.d_opt, state.d_sched(state.step + n - 1))
    state.step += n


def _make_body(cfg, group=None) -> Callable:
    """`run_steps(state, images_k, labels_k, n, draws, lr_g, lr_d, alpha_k)`:
    n train steps on images_k[i], labels_k[i] with lrs lr_g[i], lr_d[i]
    (device tensors) and uniforms from `draws`; returns the metrics stacked
    to (n,). Spectral u/v go back into D's buffers at the end. With a
    process group, the rank's part of the data-parallel step (see the
    module's docstring)."""
    ohem = bool(getattr(cfg, "ohem", False))
    fused = _use_fused_ce(cfg)
    rank, world = world_of(group)

    def mean_share(t: torch.Tensor) -> torch.Tensor:
        """The rank's share of a mean over the global batch."""
        return t if group is None else t / world

    def g_loss_fn(student, disc, images, labels, logits_t, feat_t, draws):
        preds_s = student(images, draws)
        # cross-family pairs (a floor-stride student under a ceil-stride
        # teacher) align the teacher's grid to the student's; a no-op for
        # the reference R101 → R18 pair
        if logits_t.shape[2:] != preds_s[0].shape[2:]:
            logits_t = resize_bilinear_align_corners(logits_t, tuple(preds_s[0].shape[2:]))
            feat_t = resize_bilinear_align_corners(feat_t, tuple(preds_s[2].shape[2:]))
        if ohem:
            mc = criterion_ohem_dsn(preds_s, labels, cfg.ignore_label, cfg.ohem_thresh,
                                    cfg.ohem_min_kept, group=group)
        elif fused:
            mc = criterion_dsn_fused(preds_s, labels, cfg.ignore_label, group=group)
        else:
            mc = criterion_dsn(preds_s, labels, cfg.ignore_label, group=group)
        loss = mc
        metrics = {"mc_loss": mc}
        if cfg.pi:
            pi_l = pixel_wise_kl(preds_s[0], logits_t)
            metrics["pi_loss"] = pi_l
            loss = loss + cfg.lambda_pi * pi_l
        if cfg.pa:
            pa_l = mean_share(pairwise_affinity_loss(preds_s[2], feat_t, cfg.pool_scale))
            metrics["pa_loss"] = pa_l
            loss = loss + cfg.lambda_pa * pa_l
        if cfg.ho:
            adv_g = mean_share(adv_loss_for_g(disc(preds_s[0])[0], cfg.adv_loss_type))
            metrics["adv_g_loss"] = adv_g
            loss = loss + cfg.lambda_d * adv_g
        metrics["g_loss"] = loss
        return loss, metrics, preds_s[0].detach(), logits_t

    def d_loss_fn(disc, logits_t, logits_s, draws, alpha):
        out_t = disc(logits_t)[0]
        out_s = disc(logits_s)[0]
        d_loss = cfg.lambda_d * adv_loss_for_d(out_s, out_t, cfg.adv_loss_type)
        if cfg.adv_loss_type == "wgan-gp":
            if alpha is None:
                alpha = gp_alpha(logits_t.shape[0], logits_t.device, draws)
            gp = gradient_penalty(lambda x: disc(x)[0], logits_t, logits_s, alpha,
                                  cfg.lambda_gp)
            d_loss = d_loss + cfg.lambda_d * gp
        return mean_share(d_loss)

    def sgd_step(module, loss, opt, lr):
        params = [p for p in module.parameters() if p.requires_grad]
        grads = torch.autograd.grad(loss, params)
        if group is not None:
            grads = all_reduce_sum(grads, group)
        sgd_update(opt, params, grads, lr)

    # the u8 wire's mean, made once here and copied to a device at the first
    # eager step there: a captured chunk always follows an eager one on its
    # device, so the graph reads this copy by address and never makes one (a
    # pageable host→device copy, which a capture refuses)
    mean_bgr = torch.tensor(getattr(cfg, "input_mean_bgr", IMG_MEAN_BGR),
                            dtype=torch.float32).view(3, 1, 1)
    device_means: Dict[torch.device, torch.Tensor] = {}

    def image_mean(device: torch.device) -> torch.Tensor:
        if device not in device_means:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError("the u8 wire's mean is not on the device before the capture")
            device_means[device] = mean_bgr.to(device)
        return device_means[device]

    def step(state, images, labels, draws, lr_g, lr_d, alpha) -> Metrics:
        labels = labels.to(torch.int32)
        if images.dtype == torch.uint8:
            # u8 wire (data.prefetch.quantize_u8): the raw bytes, mean added back
            images = images.float() - image_mean(images.device)
        teacher, student, disc = state.teacher, state.student, state.discriminator
        teacher.eval()
        student.train()
        disc.train()

        with torch.no_grad(), record_function("teacher_forward"):
            preds_t = teacher(images)

        # --- G (student) loss and update; the gradient reaches the student
        # parameters only
        with record_function("student_loss_and_grad"):
            g_loss, metrics, logits_s, logits_t = g_loss_fn(
                student, disc, images, labels, preds_t[0], preds_t[2], draws)
            sgd_step(student, g_loss, state.g_opt, lr_g)

        # --- D loss and update (reference discriminator_backward)
        if cfg.ho:
            with record_function("d_loss_and_grad"):
                d_loss = d_loss_fn(disc, logits_t, logits_s, draws, alpha)
                sgd_step(disc, d_loss, state.d_opt, lr_d)
            metrics["d_loss"] = d_loss
        else:
            metrics["d_loss"] = torch.zeros((), device=images.device)
        if group is not None:
            metrics = dict(zip(metrics, all_reduce_sum(list(metrics.values()), group)))
        return {k: v.detach() for k, v in metrics.items()}

    def run_steps(state, images_k, labels_k, n, draws, lr_g, lr_d, alpha_k=None) -> Metrics:
        if group is not None:
            draws = _RowShard(draws, rank, world)
        steps = []
        with spectral_in_place(state.discriminator):
            for i in range(n):
                alpha = None if alpha_k is None else alpha_k[i]
                steps.append(step(state, images_k[i], labels_k[i], draws, lr_g[i], lr_d[i],
                                  alpha))
        return {k: torch.stack([m[k] for m in steps]) for k in steps[0]}

    return run_steps


def _run_eager(run_steps, state, images_k, labels_k, n_valid, unroll, generator,
               alpha_k=None, draws=None) -> Metrics:
    """The first n_valid steps of a chunk, eagerly; the metrics padded with
    zeros to (unroll,), as the JAX loop's masked steps return them."""
    device = images_k.device
    lrs = torch.tensor(_lr_values(state, n_valid), dtype=torch.float32).to(device)
    draws = _HostDraws(generator, device) if draws is None else draws
    metrics = run_steps(state, images_k, labels_k, n_valid, draws, lrs[:n_valid],
                        lrs[n_valid:], alpha_k)
    _advance(state, n_valid)
    if n_valid < unroll:
        metrics = {k: torch.cat([v, v.new_zeros(unroll - n_valid)]) for k, v in metrics.items()}
    return metrics


def make_train_step(cfg, group=None) -> Callable:
    """The train step for a TrainConfig: `train_step(state, images, labels,
    generator=None, alpha=None)` takes (N, 3, H, W) images (f32, bf16 from
    the narrowed wire, or uint8 from the u8 wire, which becomes f32 minus
    `cfg.input_mean_bgr` on the device before the model's own cast) and
    (N, H, W) integer labels (int32, or uint8 from the wire, widened to
    int32 on the device first, as the JAX step does) on the models' device,
    updates `state` in place and returns its metrics as 0-dim f32 tensors.
    It is the multi-step loop's eager path with one step. With a process
    `group`, the batch is this rank's slice of the global batch, and a fed
    `alpha` holds this rank's rows of the global α."""
    run_steps = _make_body(cfg, group)

    def train_step(state: KDTrainState, images: torch.Tensor, labels: torch.Tensor,
                   generator: Optional[torch.Generator] = None,
                   alpha: Optional[torch.Tensor] = None) -> Metrics:
        metrics = _run_eager(run_steps, state, images[None], labels[None], 1, 1, generator,
                             None if alpha is None else alpha[None])
        return {k: v[0] for k, v in metrics.items()}

    return train_step


def _state_tensors(state: KDTrainState) -> list:
    """Every tensor a captured chunk reads or writes in place: the models'
    parameters and buffers and the momentum buffers."""
    out = []
    for module in (state.teacher, state.student, state.discriminator):
        out += list(module.parameters()) + list(module.buffers())
    for opt in (state.g_opt, state.d_opt):
        out += [s["momentum_buffer"] for s in opt.state.values() if "momentum_buffer" in s]
    return out


@dataclass
class _Graph:
    """One captured chunk: its static inputs, what it was captured against,
    then the CUDA graph and its static outputs."""

    images: torch.Tensor
    labels: torch.Tensor
    scalars: torch.Tensor
    signature: tuple
    graph: Optional[torch.cuda.CUDAGraph] = None
    outputs: Optional[Metrics] = None


class TrainLoop:
    """`loop(state, images_k, labels_k, n_valid, generator=None, alpha_k=None)`:
    the first n_valid steps of a chunk of stacked (unroll, N, 3, H, W) images
    and (unroll, N, H, W) labels on the models' device; advances `state.step`
    by n_valid and returns every metric stacked to (unroll,), zeros past
    n_valid. `alpha_k` (unroll, N, 1, 1, 1), the GP α fed instead of drawn,
    is for CPU tensors only. See the module's docstring for the card's path
    and for a process `group`: with gloo, chunks on the card run eagerly.
    Counters:
    `eager_steps`, `replayed_steps`, `replays`, `captures` and `capture_ms`
    (the last capture's host time)."""

    def __init__(self, cfg, unroll: int, group=None):
        if unroll < 1:
            raise ValueError(f"unroll should be >= 1, got {unroll}")
        self.unroll = int(unroll)
        self._run_steps = _make_body(cfg, group)
        # gloo collectives cannot be captured in a CUDA graph
        self._eager_only = group is not None and dist.get_backend(group) == "gloo"
        self.stream: Optional[torch.cuda.Stream] = None
        self._graph: Optional[_Graph] = None
        self._plan: Optional[List[tuple]] = None  # uniform shapes a step draws
        self._host: Optional[torch.Tensor] = None  # pinned staging of the scalars
        self._host_free: Optional[torch.cuda.Event] = None
        self.eager_steps = self.replayed_steps = self.replays = self.captures = 0
        self.capture_ms = 0.0

    @property
    def graph(self) -> Optional[torch.cuda.CUDAGraph]:
        return None if self._graph is None else self._graph.graph

    @property
    def static_scalars(self) -> Optional[torch.Tensor]:
        """The device buffer of the last replay: unroll G lrs, unroll D lrs,
        then each step's uniforms in the order the steps draw them."""
        return None if self._graph is None else self._graph.scalars

    def __call__(self, state: KDTrainState, images_k: torch.Tensor, labels_k: torch.Tensor,
                 n_valid: int, generator: Optional[torch.Generator] = None,
                 alpha_k: Optional[torch.Tensor] = None) -> Metrics:
        k = self.unroll
        if images_k.shape[0] != k or labels_k.shape[0] != k or not 1 <= n_valid <= k:
            raise ValueError(f"a chunk of {k} steps with 1..{k} valid, got images "
                             f"{tuple(images_k.shape)}, labels {tuple(labels_k.shape)}, "
                             f"n_valid {n_valid}")
        if images_k.device.type != "cuda":
            return _run_eager(self._run_steps, state, images_k, labels_k, n_valid, k,
                              generator, alpha_k)
        if self._eager_only:
            self.eager_steps += n_valid
            return _run_eager(self._run_steps, state, images_k, labels_k, n_valid, k,
                              generator)
        if alpha_k is not None:
            raise ValueError("a fed α is for CPU parity runs; on the card the loop draws α "
                             "from the generator")
        if self.stream is None:
            self.stream = torch.cuda.Stream(images_k.device)
        current = torch.cuda.current_stream(images_k.device)
        self.stream.wait_stream(current)
        for t in (images_k, labels_k):
            t.record_stream(self.stream)
        with torch.cuda.stream(self.stream):
            metrics = self._on_card(state, images_k, labels_k, n_valid, generator)
        current.wait_stream(self.stream)
        for v in metrics.values():
            v.record_stream(current)
        return metrics

    def _on_card(self, state, images_k, labels_k, n_valid, generator) -> Metrics:
        k = self.unroll
        if self._graph is not None and self._graph.signature != self._signature(
                state, images_k, labels_k):
            log.warning("the train state's tensors or the chunk's shapes changed since the "
                        "capture: the next full chunk runs eagerly, the one after recaptures")
            self._graph, self._plan = None, None
        if n_valid < k or self._plan is None:
            # a tail, or the warm-up chunk of a capture
            draws = _HostDraws(generator, images_k.device)
            metrics = _run_eager(self._run_steps, state, images_k, labels_k, n_valid, k,
                                 generator, draws=draws)
            self.eager_steps += n_valid
            if n_valid == k:
                per_step = len(draws.shapes) // k
                plan = draws.shapes[:per_step]
                if draws.shapes != plan * k:
                    raise RuntimeError(f"the steps of a chunk drew different uniforms: "
                                       f"{draws.shapes}")
                self._plan = plan
            return metrics
        if self._graph is None:
            self._capture(state, images_k, labels_k, generator)
        else:
            self._stage(state, images_k, labels_k, generator)
        self._graph.graph.replay()
        _advance(state, k)
        self.replays += 1
        self.replayed_steps += k
        return {name: v.clone() for name, v in self._graph.outputs.items()}

    def _signature(self, state, images_k, labels_k) -> tuple:
        return (tuple(t.data_ptr() for t in _state_tensors(state)),
                tuple(images_k.shape), images_k.dtype, tuple(labels_k.shape), labels_k.dtype)

    def _stage(self, state, images_k, labels_k, generator) -> None:
        """Copy the chunk into the static inputs and write its lrs and
        uniforms into the scalar buffer, on the loop's stream."""
        g = self._graph
        g.images.copy_(images_k)
        g.labels.copy_(labels_k)
        k = self.unroll
        if self._host_free is not None:
            self._host_free.synchronize()  # the previous chunk's copy has read it
        host = self._host
        host[:2 * k] = torch.tensor(_lr_values(state, k), dtype=torch.float32)
        offset = 2 * k
        for _ in range(k):
            for shape in self._plan:
                n = math.prod(shape)
                host[offset:offset + n] = torch.rand(shape, generator=generator).reshape(-1)
                offset += n
        g.scalars.copy_(host, non_blocking=True)
        self._host_free = torch.cuda.Event()
        self._host_free.record(self.stream)

    def _capture(self, state, images_k, labels_k, generator) -> None:
        k = self.unroll
        device = images_k.device
        n_scalars = 2 * k + k * sum(math.prod(s) for s in self._plan)
        self._host = torch.empty(n_scalars, dtype=torch.float32, pin_memory=True)
        for module, opt in ((state.student, state.g_opt), (state.discriminator, state.d_opt)):
            momentum_buffers(opt, [p for p in module.parameters() if p.requires_grad])
        self._graph = _Graph(torch.empty_like(images_k), torch.empty_like(labels_k),
                             torch.empty(n_scalars, dtype=torch.float32, device=device),
                             self._signature(state, images_k, labels_k))
        self._stage(state, images_k, labels_k, generator)
        g = self._graph
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        try:
            draws = _BufferDraws(g.scalars[2 * k:], self._plan)
            # thread_local: the prefetch thread keeps staging batches (pinned
            # and device allocations on its own stream) during the capture
            with torch.cuda.graph(graph, stream=self.stream, capture_error_mode="thread_local"):
                g.outputs = self._run_steps(state, g.images, g.labels, k, draws, g.scalars[:k],
                                            g.scalars[k:2 * k])
            if draws.offset != draws.flat.numel():
                raise RuntimeError(f"the captured chunk drew {draws.offset} of "
                                   f"{draws.flat.numel()} uniforms")
        except BaseException:
            self._graph = None
            raise
        self.capture_ms = 1e3 * (time.perf_counter() - t0)
        self.captures += 1
        g.graph = graph


def make_train_loop(cfg, unroll: int, group=None) -> TrainLoop:
    """The multi-step loop of `unroll` steps (a rank's part of it with a
    process `group`); see `TrainLoop`."""
    return TrainLoop(cfg, unroll, group)
