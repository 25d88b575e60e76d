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

import functools

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import (
    _interp_matrix_np,
    resize_bilinear_align_corners,
)

__all__ = ["upsampled_argmax", "upsampled_argmax_plain", "tap_tables"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def upsampled_argmax_plain(logits: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """The plain PyTorch version: resize with the f32 align-corners matrices
    (height, then width), then the first-index argmax over dim 1.
    Returns (N, H, W) int32."""
    up = resize_bilinear_align_corners(logits.float(), out_size)
    return up.argmax(dim=1).to(torch.int32)


def tap_tables(n_in: int, n_out: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-output-sample (lo, hi) source taps and their weights, as (2, n_out)
    int32 and float32 arrays: the first and last non-zero entry of each row of
    the align-corners matrix, so the weights equal its entries bit for bit.
    Where a row has one non-zero entry (the last sample, an integral source
    position, a 1-sample axis) lo == hi and the high weight is 0."""
    a = _interp_matrix_np(n_in, n_out)
    nz = a != 0
    lo = nz.argmax(axis=1)
    hi = n_in - 1 - nz[:, ::-1].argmax(axis=1)
    rows = np.arange(n_out)
    w_hi = np.where(hi != lo, a[rows, hi], np.float32(0.0))
    return (np.stack([lo, hi]).astype(np.int32),
            np.stack([a[rows, lo], w_hi]).astype(np.float32))


@functools.lru_cache(maxsize=32)
def _device_tables(n_in: int, n_out: int, device: torch.device):
    idx, wt = tap_tables(n_in, n_out)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device)


def upsampled_argmax(logits: torch.Tensor, out_size: tuple[int, int]) -> torch.Tensor:
    """argmax_C(resize_align_corners(logits, out_size)) as (N, H, W) int32.

    logits: (N, C, h, w) float32 or bfloat16, contiguous; the interpolation
    runs in f32. A CPU tensor takes `upsampled_argmax_plain`; a CUDA tensor
    launches the kernel or raises.
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

    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    row_idx, row_wt = _device_tables(h_in, h_out, logits.device)
    col_idx, col_wt = _device_tables(w_in, w_out, logits.device)
    out = torch.empty((n, h_out, w_out), dtype=torch.int32, device=logits.device)
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.skd_upsampled_argmax(
            logits.data_ptr(), _DTYPE_CODES[logits.dtype],
            row_idx.data_ptr(), row_wt.data_ptr(), col_idx.data_ptr(),
            col_wt.data_ptr(), out.data_ptr(), n, c, h_in, w_in, h_out, w_out,
            stream)
    if err != 0:
        raise RuntimeError(f"upsampled_argmax kernel launch failed: cudaError {err}")
    upsampled_argmax.launches += 1
    return out


upsampled_argmax.launches = 0
