"""Host tables of the align-corners interpolation, shared by the kernels that
interpolate tap by tap: the upsampled argmax (K1, `ops/upsampled_argmax.py`)
and the upsampled cross-entropy (K2–K5, `ops/upsampled_ce.py`).

Each output sample of an align-corners resize reads at most two adjacent
input samples. `tap_tables` gives them and their weights, `tap_intervals`
groups the output samples by their first tap (a block of the interval-tiled
kernels walks one such group of rows), and `window_tiling` picks how many
output columns one block takes so that the low-res columns they read fit the
block's shared memory.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import _interp_matrix_np

__all__ = ["tap_tables", "tap_intervals", "window_smem_bytes", "window_tiling", "SMEM_MAX"]

SMEM_MAX = 227 * 1024  # the H100's dynamic shared memory per block


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


# the device tables are cached without bound: a captured CUDA graph (the
# multi-step train loop) reads them by address, so an entry must never be
# evicted and freed while a graph lives
@functools.lru_cache(maxsize=None)
def _device_tables(n_in: int, n_out: int, device: torch.device):
    idx, wt = tap_tables(n_in, n_out)
    return torch.from_numpy(idx).to(device), torch.from_numpy(wt).to(device)


def tap_intervals(n_in: int, n_out: int) -> np.ndarray:
    """(n_in + 1,) int32 offsets: the output samples whose first tap is input
    sample j are [start[j], start[j+1]), the interval (a row) that one block
    of the interval-tiled kernels walks, or the cell (a column) of the CE
    backward. The first tap is monotone
    in the output index and the second is the first or the one after it
    (both checked), so each output sample of interval j reads only inputs j
    and j + 1, and its weight on j + 1 is 0 where it has no second tap."""
    idx, _ = tap_tables(n_in, n_out)
    lo, hi = idx.astype(np.int64)
    if (np.diff(lo) < 0).any() or not ((hi == lo) | (hi == lo + 1)).all():
        raise AssertionError(f"taps of {n_in} -> {n_out} are not monotone adjacent pairs")
    return np.searchsorted(lo, np.arange(n_in + 1), side="left").astype(np.int32)


@functools.lru_cache(maxsize=None)
def _device_intervals(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(tap_intervals(n_in, n_out)).to(device)


def window_smem_bytes(c_all: int, ncols: int) -> int:
    """The dynamic shared memory of an interval-tiled block whose window
    reads ncols low-res columns: rows i and i + 1 of those columns of every
    channel, staged, and their H interpolation as pairs (V[col], V[col+1]),
    4·c_all·ncols words (fwd_smem_bytes of csrc/upsampled_ce.cu,
    window_smem_bytes of csrc/upsampled_argmax.cu)."""
    return 16 * c_all * ncols


@functools.lru_cache(maxsize=64)
def window_tiling(c_all: int, w_in: int, w_out: int, px_max: int, smem_max: int,
                  kernel: str) -> tuple[int, int]:
    """(px, ncols): high-res columns per block, halved from px_max while the
    low-res columns that the widest window of px columns reads (ncols, from
    its first pixel's first tap to its last pixel's second) overfill
    smem_max bytes of shared memory. Raises ValueError, naming `kernel`,
    where even a one-column window does not fit."""
    (lo, hi), _ = tap_tables(w_in, w_out)

    def widest(px: int) -> int:
        x0 = np.arange(0, w_out, px)
        return int((hi[np.minimum(x0 + px, w_out) - 1] - lo[x0]).max()) + 1

    px = px_max
    while px > 1 and window_smem_bytes(c_all, widest(px)) > smem_max:
        px //= 2
    ncols = widest(px)
    if window_smem_bytes(c_all, ncols) > smem_max:
        raise ValueError(f"{c_all} channels are too many for {kernel} "
                         f"({window_smem_bytes(c_all, ncols)} bytes of shared memory per block)")
    return px, ncols
