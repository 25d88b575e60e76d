"""Cross-entropy over align-corners-upsampled logits (kernels K2–K5).

Counterpart of `structure_knowledge_distillation_tpu/ops/pallas_ce.py`. The
DSN loss upsamples stride-8 logits to the label resolution and takes the
ignore-masked mean cross-entropy (reference utils/criterion.py:179-188).
Done literally at the train shape that materialises an (8,19,512,512) f32
tensor per head, and as much again for its gradient.

`upsampled_ce_loss` (one head, K2/K3) and `upsampled_ce_loss_dsn` (main and
aux heads in one pass, CE(main↑) + dsn_weight·CE(aux↑), K4/K5) are
`torch.autograd.Function`s. On a CUDA tensor their forward and backward are
the hand-written kernels of `csrc/upsampled_ce.cu`, which never materialise
the upsampled logits; on a CPU tensor they take the `*_plain` versions beside
them (resize with the f32 align-corners matrices, then `cross_entropy_ignore`,
differentiated by autograd). There is no size gate: the JAX package's VMEM
budget was a TPU measure.

Logits are NCHW, float32 or bfloat16; the arithmetic is f32 and the
gradient comes back in the logits' dtype. Labels are (N, H, W) integers.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.taps import (
    SMEM_MAX as _SMEM_MAX,
    _device_intervals,
    _device_tables,
    tap_intervals,
    window_smem_bytes as _fwd_smem_bytes,
    window_tiling,
)

__all__ = [
    "cross_entropy_ignore",
    "upsampled_ce_loss",
    "upsampled_ce_loss_dsn",
    "upsampled_ce_loss_plain",
    "upsampled_ce_loss_dsn_plain",
    "tap_intervals",
]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_FWD_PX = 512  # high-res columns per forward block: csrc/upsampled_ce.cu's 256
# threads (kFwdThreads), 2 pixels each (kFwdPx)
_BWD_PX = 128  # pixels per chunk of the backward's softmax buffer: with 2 heads,
# one thread per (pixel, head) of csrc/upsampled_ce.cu's 256 (kBwdThreads)
_BWD_SMEM_SOFT = 64 * 1024  # keeps several backward blocks on an SM
_FWD_SMEM_MAX = _SMEM_MAX - 3 * 4 * 256  # less the forward's static reduction buffers


def cross_entropy_ignore(logits: torch.Tensor, labels: torch.Tensor,
                         ignore_index: int = 255) -> torch.Tensor:
    """Mean CE over non-ignored pixels; logits (N, C, H, W), labels (N, H, W).

    lse − picked with f32 accumulation and a detached max shift, as the JAX
    `losses/task.py::cross_entropy_ignore`."""
    labels = labels.long()
    mask = labels != ignore_index
    safe = torch.where(mask, labels, torch.zeros_like(labels))
    m = logits.detach().amax(dim=1, keepdim=True)
    lse = m[:, 0].float() + torch.log(torch.exp((logits - m).float()).sum(dim=1))
    picked = logits.gather(1, safe[:, None])[:, 0]
    ce = lse - picked.float()
    total = torch.where(mask, ce, torch.zeros_like(ce)).sum()
    count = mask.sum().clamp_min(1)
    return total / count


def upsampled_ce_loss_plain(logits: torch.Tensor, labels: torch.Tensor,
                            out_size: tuple[int, int], ignore_index: int = 255) -> torch.Tensor:
    """The plain version of K2/K3: f32 align-corners resize, then CE."""
    up = resize_bilinear_align_corners(logits.float(), out_size)
    return cross_entropy_ignore(up, labels, ignore_index)


def upsampled_ce_loss_dsn_plain(logits: torch.Tensor, aux_logits: torch.Tensor,
                                labels: torch.Tensor, out_size: tuple[int, int],
                                ignore_index: int = 255, dsn_weight: float = 0.4) -> torch.Tensor:
    """The plain version of K4/K5: CE(main↑) + dsn_weight·CE(aux↑)."""
    return (upsampled_ce_loss_plain(logits, labels, out_size, ignore_index)
            + dsn_weight * upsampled_ce_loss_plain(aux_logits, labels, out_size, ignore_index))


def _fwd_tiling(c_all: int, w_in: int, w_out: int) -> tuple[int, int]:
    """(px, ncols) of the forward: high-res columns per block and the most
    low-res columns a window reads (`taps.window_tiling`, from _FWD_PX)."""
    return window_tiling(c_all, w_in, w_out, _FWD_PX, _FWD_SMEM_MAX, "the CE forward kernel")


def _bwd_smem_bytes(c_all: int, w_in: int, seg: int, px: int) -> int:
    """The backward pass-1 kernel's dynamic shared memory, 4-byte words: the
    staged logits and their H interpolation (3·c_all·(seg+1)), the softmax of
    a chunk of px pixels (row stride c_all | 1), the 4 corner sums per cell
    and channel, 5 words per pixel (label, 2 column weights, scale/Σexp of
    each head, padded to an even count) and each column's pixel range, 2
    words (csrc/upsampled_ce.cu bwd_smem_bytes)."""
    nj, ncols = min(seg, w_in), min(seg + 1, w_in)
    return 4 * (3 * c_all * ncols + px * (c_all | 1) + 4 * nj * c_all + 5 * px + (px & 1)
                + 2 * seg)


@functools.lru_cache(maxsize=32)
def _bwd_tiling(c_all: int, w_in: int, w_out: int) -> tuple[int, int, int]:
    """(seg, px, smem bytes) of the backward's pass 1: low-res columns per
    block, halved while the block's shared memory exceeds _BWD_SMEM_SOFT
    (occupancy), then narrowed until every segment's pixels fit one chunk of
    _BWD_PX; the chunk is halved while the block exceeds the card's
    _SMEM_MAX. Raises ValueError where even one column and one pixel do not
    fit."""
    start = tap_intervals(w_in, w_out)
    px = _BWD_PX

    def widest(seg: int) -> int:
        lo = np.arange(0, w_in, seg)
        return int((start[np.minimum(lo + seg, w_in)] - start[lo]).max())

    seg = w_in
    while seg > 1 and _bwd_smem_bytes(c_all, w_in, seg, px) > _BWD_SMEM_SOFT:
        seg = (seg + 1) // 2
    while seg > 1 and widest(seg) > px:
        seg -= 1
    while px > 1 and _bwd_smem_bytes(c_all, w_in, seg, px) > _SMEM_MAX:
        px //= 2
    smem = _bwd_smem_bytes(c_all, w_in, seg, px)
    if smem > _SMEM_MAX:
        raise ValueError(f"{c_all} channels are too many for the CE backward kernel "
                         f"({smem} bytes of shared memory per block)")
    return seg, px, smem


def _check(heads: tuple, labels: torch.Tensor, out_size) -> tuple[int, int]:
    x = heads[0]
    if x.dim() != 4:
        raise ValueError(f"expected (N, C, h, w) logits, got shape {tuple(x.shape)}")
    for h in heads:
        if h.dtype not in _DTYPE_CODES:
            raise TypeError(f"logits must be float32 or bfloat16, got {h.dtype}")
        if h.shape != x.shape or h.dtype != x.dtype or h.device != x.device:
            raise ValueError("the two heads must agree in shape, dtype and device")
    h_out, w_out = (int(s) for s in out_size)
    if labels.shape != (x.shape[0], h_out, w_out):
        raise ValueError(f"labels {tuple(labels.shape)} do not match logits "
                         f"{tuple(x.shape)} and out_size {out_size}")
    if h_out <= 0 or w_out <= 0 or x.numel() == 0:
        raise ValueError(f"empty input: logits {tuple(x.shape)}, out_size {out_size}")
    return h_out, w_out


def _launch_fwd(heads: tuple, labels: torch.Tensor, out_size, ignore_index: int,
                dsn_weight: float):
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    x = heads[0]
    if x.device.type != "cuda":
        raise ValueError(f"no upsampled CE kernel for device {x.device}")
    if not all(h.is_contiguous() for h in heads):
        raise ValueError("logits must be contiguous (NCHW)")
    lib = load_kernels()
    n, c, h_in, w_in = x.shape
    h_out, w_out = out_size
    dev = x.device
    px, ncols = _fwd_tiling(len(heads) * c, w_in, w_out)
    row_idx, row_wt = _device_tables(h_in, h_out, dev)
    col_idx, col_wt = _device_tables(w_in, w_out, dev)
    row_start = _device_intervals(h_in, h_out, dev)
    nparts = n * h_in * -(-w_out // px)  # one per block
    part_sums = torch.empty(2 * nparts, dtype=torch.float32, device=dev)
    part_cnt = torch.empty(nparts, dtype=torch.int32, device=dev)
    sums = torch.empty(2, dtype=torch.float32, device=dev)
    count = torch.empty(1, dtype=torch.int32, device=dev)
    loss = torch.empty((), dtype=torch.float32, device=dev)
    aux = heads[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.skd_upsampled_ce_fwd(
            x.data_ptr(), aux.data_ptr(), _DTYPE_CODES[x.dtype], len(heads),
            labels.data_ptr(), row_idx.data_ptr(), row_wt.data_ptr(), col_idx.data_ptr(),
            col_wt.data_ptr(), row_start.data_ptr(), part_sums.data_ptr(), part_cnt.data_ptr(),
            sums.data_ptr(), count.data_ptr(), loss.data_ptr(), n, c, h_in, w_in, h_out, w_out,
            int(ignore_index), float(dsn_weight), px, ncols, stream)
    if err != 0:
        raise RuntimeError(f"upsampled CE forward kernel launch failed: cudaError {err}")
    return loss, count


def _launch_bwd(heads: tuple, labels: torch.Tensor, count: torch.Tensor, grad: torch.Tensor,
                out_size, ignore_index: int, dsn_weight: float) -> list:
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    x = heads[0]
    n, c, h_in, w_in = x.shape
    h_out, w_out = out_size
    dev = x.device
    c_all = len(heads) * c
    seg, px, smem = _bwd_tiling(c_all, w_in, w_out)
    row_idx, row_wt = _device_tables(h_in, h_out, dev)
    col_idx, col_wt = _device_tables(w_in, w_out, dev)
    row_start = _device_intervals(h_in, h_out, dev)
    col_start = _device_intervals(w_in, w_out, dev)
    grad = grad.detach().to(torch.float32).reshape(1).contiguous()
    # per low-res row interval: its corner sums on rows i and i+1, and each
    # column segment's right edge
    part = torch.empty((n, h_in, 2, c_all, w_in), dtype=torch.float32, device=dev)
    edge = torch.empty((n, h_in, 2, c_all, -(-w_in // seg)), dtype=torch.float32, device=dev)
    dxs = [torch.empty_like(h) for h in heads]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.skd_upsampled_ce_bwd(
            x.data_ptr(), heads[-1].data_ptr(), _DTYPE_CODES[x.dtype], len(heads),
            labels.data_ptr(), row_idx.data_ptr(), row_wt.data_ptr(), col_idx.data_ptr(),
            col_wt.data_ptr(), row_start.data_ptr(), col_start.data_ptr(), grad.data_ptr(),
            count.data_ptr(), part.data_ptr(), edge.data_ptr(), dxs[0].data_ptr(),
            dxs[-1].data_ptr(), n, c, h_in, w_in, h_out, w_out, int(ignore_index),
            float(dsn_weight), seg, px, smem, stream)
    if err != 0:
        raise RuntimeError(f"upsampled CE backward kernel launch failed: cudaError {err}")
    return dxs


def _labels_i32(labels: torch.Tensor) -> torch.Tensor:
    return labels.to(torch.int32).contiguous()


class _UpsampledCE(torch.autograd.Function):
    """Forward and backward on the card; `counter` is the public wrapper whose
    `launches`/`bwd_launches` count the kernel launches."""

    @staticmethod
    def forward(ctx, counter, out_size, ignore_index, dsn_weight, labels, *heads):
        labels = _labels_i32(labels)
        if any(ctx.needs_input_grad):  # a shape the backward cannot take raises here
            _bwd_tiling(len(heads) * heads[0].shape[1], heads[0].shape[3], out_size[1])
        loss, count = _launch_fwd(heads, labels, out_size, ignore_index, dsn_weight)
        counter.launches += 1
        ctx.save_for_backward(labels, count, *heads)
        ctx.meta = (counter, out_size, ignore_index, dsn_weight)
        return loss

    @staticmethod
    def backward(ctx, grad):
        labels, count, *heads = ctx.saved_tensors
        counter, out_size, ignore_index, dsn_weight = ctx.meta
        dxs = _launch_bwd(tuple(heads), labels, count, grad, out_size, ignore_index,
                          dsn_weight)
        counter.bwd_launches += 1
        return (None, None, None, None, None, *dxs)


def upsampled_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                      out_size: tuple[int, int], ignore_index: int = 255) -> torch.Tensor:
    """mean CE(resize_align_corners(logits, out_size), labels) with ignore.

    logits (N, C, h, w) float32/bfloat16, labels (N, H, W) int. A CPU tensor
    takes `upsampled_ce_loss_plain`; a CUDA tensor launches K2 forward and K3
    backward, or raises."""
    out_size = _check((logits,), labels, out_size)
    if logits.device.type == "cpu":
        return upsampled_ce_loss_plain(logits, labels, out_size, ignore_index)
    return _UpsampledCE.apply(upsampled_ce_loss, out_size, ignore_index, 0.0, labels, logits)


def upsampled_ce_loss_dsn(logits: torch.Tensor, aux_logits: torch.Tensor,
                          labels: torch.Tensor, out_size: tuple[int, int],
                          ignore_index: int = 255, dsn_weight: float = 0.4) -> torch.Tensor:
    """CE(main↑) + dsn_weight·CE(aux↑) in one pass over both heads.

    The heads must agree in shape and dtype. A CPU tensor takes
    `upsampled_ce_loss_dsn_plain`; a CUDA tensor launches K4 forward and K5
    backward, or raises."""
    out_size = _check((logits, aux_logits), labels, out_size)
    if logits.device.type == "cpu":
        return upsampled_ce_loss_dsn_plain(logits, aux_logits, labels, out_size,
                                           ignore_index, dsn_weight)
    return _UpsampledCE.apply(upsampled_ce_loss_dsn, out_size, ignore_index, dsn_weight,
                              labels, logits, aux_logits)


for _fn in (upsampled_ce_loss, upsampled_ce_loss_dsn):
    _fn.launches = 0      # forward kernel launches
    _fn.bwd_launches = 0  # backward kernel launches
