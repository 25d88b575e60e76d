"""argmax over classes of align-corners-upsampled logits (kernel K1).

Counterpart of `structure_knowledge_distillation_tpu/ops/pallas_eval.py`.
Whole-image eval upsamples stride-8 logits to the output resolution and takes
the per-pixel argmax (reference networks/evaluate.py:106-113,183-187). Done
literally at Cityscapes full resolution that materialises a (1,19,1024,2048)
f32 tensor (159 MB) only to reduce it to a class map.

`upsampled_argmax` launches the hand-written CUDA kernel of
`csrc/upsampled_argmax.cu` on a CUDA tensor, which never materialises the
upsampled logits, and takes `upsampled_argmax_plain` on a CPU tensor. There is
no size gate: the JAX package's ≥1M-pixel gate was measured on a TPU, and the
eval path on CUDA always takes the kernel. Ties go to the first class index,
as in torch and jnp argmax.
"""

from __future__ import annotations

import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.taps import (
    SMEM_MAX,
    _device_intervals,
    _device_tables,
    tap_tables,
    window_tiling,
)

__all__ = ["upsampled_argmax", "upsampled_argmax_plain", "tap_tables"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_PX = 512  # high-res columns per block: csrc/upsampled_argmax.cu's 256 threads
# (kThreads), 2 pixels each (kPx)


def upsampled_argmax_plain(logits: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version: resize with the f32 align-corners matrices
    (height, then width), then the first-index argmax over dim 1.
    Returns (N, H, W) int32."""
    up = resize_bilinear_align_corners(logits.float(), out_size)
    return up.argmax(dim=1).to(torch.int32)


def _tiling(c: int, w_in: int, w_out: int) -> tuple[int, int]:
    """(px, ncols) of the kernel: high-res columns per block and the most
    low-res columns a window reads (`taps.window_tiling`, from _PX)."""
    return window_tiling(c, w_in, w_out, _PX, SMEM_MAX, "the argmax kernel")


def upsampled_argmax(logits: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """argmax_C(resize_align_corners(logits, out_size)) as (N, H, W) int32.

    logits: (N, C, h, w) float32 or bfloat16, contiguous; the interpolation
    runs in f32. A CPU tensor takes `upsampled_argmax_plain`; a CUDA tensor
    launches the kernel or raises (ValueError, before launch, past about
    7200 classes: a block then cannot hold the two low-res columns a pixel
    reads).
    """
    if logits.dim() != 4:
        raise ValueError(f"expected (N, C, h, w) logits, got shape {tuple(logits.shape)}")
    if logits.dtype not in _DTYPE_CODES:
        raise TypeError(f"logits must be float32 or bfloat16, got {logits.dtype}")
    h_out, w_out = (int(s) for s in out_size)
    if h_out <= 0 or w_out <= 0:
        raise ValueError(f"bad out_size {out_size}")
    if logits.device.type == "cpu":
        return upsampled_argmax_plain(logits, (h_out, w_out))
    if logits.device.type != "cuda":
        raise ValueError(f"no upsampled_argmax for device {logits.device}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous (NCHW)")
    n, c, h_in, w_in = logits.shape
    if n * c * h_in * w_in == 0:
        raise ValueError(f"empty logits {tuple(logits.shape)}")

    px, ncols = _tiling(c, w_in, w_out)  # a class count no block holds raises here

    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    dev = logits.device
    row_idx, row_wt = _device_tables(h_in, h_out, dev)
    col_idx, col_wt = _device_tables(w_in, w_out, dev)
    row_start = _device_intervals(h_in, h_out, dev)
    out = torch.empty((n, h_out, w_out), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.skd_upsampled_argmax(
            logits.data_ptr(), _DTYPE_CODES[logits.dtype], row_idx.data_ptr(),
            row_wt.data_ptr(), col_idx.data_ptr(), col_wt.data_ptr(), row_start.data_ptr(),
            out.data_ptr(), n, c, h_in, w_in, h_out, w_out, px, ncols, stream)
    if err != 0:
        raise RuntimeError(f"upsampled_argmax kernel launch failed: cudaError {err}")
    upsampled_argmax.launches += 1
    return out


upsampled_argmax.launches = 0
