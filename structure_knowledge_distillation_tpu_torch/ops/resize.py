"""Align-corners bilinear resize of NCHW tensors, as two matmuls.

Counterpart of `structure_knowledge_distillation_tpu/ops/resize.py`. The 1-D
operators are built exactly as the JAX package builds them (float64, then cast
to float32), so both packages interpolate with bit-identical weights; that is
what lets the argmax kernel's per-pixel weight tables equal the JAX matrices'
entries.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["resize_bilinear_align_corners", "interp_matrix_align_corners"]


@functools.lru_cache(maxsize=None)
def _interp_matrix_np(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) align-corners linear-interpolation operator."""
    a = np.zeros((n_out, n_in), dtype=np.float64)
    if n_out == 1:
        # torch semantics: single output sample reads source coordinate 0.
        a[0, 0] = 1.0
        return a.astype(np.float32)
    if n_in == 1:
        a[:, 0] = 1.0
        return a.astype(np.float32)
    src = np.arange(n_out, dtype=np.float64) * (n_in - 1) / (n_out - 1)
    lo = np.floor(src).astype(np.int64)
    lo = np.clip(lo, 0, n_in - 1)
    hi = np.clip(lo + 1, 0, n_in - 1)
    frac = src - lo
    rows = np.arange(n_out)
    np.add.at(a, (rows, lo), 1.0 - frac)
    np.add.at(a, (rows, hi), frac)
    return a.astype(np.float32)


# unbounded, as the tap tables of ops/taps.py: a captured CUDA graph reads
# the matrices by address, so an entry must never be evicted and freed
@functools.lru_cache(maxsize=None)
def interp_matrix_align_corners(n_in: int, n_out: int,
                                device: torch.device | str = "cpu") -> torch.Tensor:
    """The (n_out, n_in) float32 align-corners operator on `device`."""
    return torch.from_numpy(_interp_matrix_np(n_in, n_out)).to(device)


def _operator(n_in: int, n_out: int, device: torch.device) -> torch.Tensor:
    """`interp_matrix_align_corners`, but made afresh while `torch.export` or
    `torch.compile` traces: there the tensor made is a fake one (a constant
    of the traced program), which the cache must not keep for later eager
    calls."""
    if torch.compiler.is_compiling():
        return torch.from_numpy(_interp_matrix_np(n_in, n_out)).to(device)
    return interp_matrix_align_corners(n_in, n_out, device)


def resize_bilinear_align_corners(x: torch.Tensor, size: tuple[int, int],
                                  exact: bool = True) -> torch.Tensor:
    """Bilinear align-corners resize of an NCHW tensor to `size` = (H, W).

    Matches ``F.interpolate(mode='bilinear', align_corners=True)`` up to float
    association. With `exact` (the default) the arithmetic is float32 whatever
    the input dtype, and the result keeps the input dtype, as in the JAX
    version's exact mode. `exact=False` interpolates in the input's own dtype
    (the JAX non-exact mode, which its bf16 `criterion_dsn` takes).
    """
    if x.dim() != 4:
        raise ValueError(f"expected NCHW input, got shape {tuple(x.shape)}")
    h_out, w_out = size
    h_in, w_in = x.shape[2], x.shape[3]
    if (h_in, w_in) == (h_out, w_out):
        return x
    a_h = _operator(h_in, h_out, x.device)
    a_w = _operator(w_in, w_out, x.device)
    if not exact and x.dtype != torch.float32:
        a_h, a_w = a_h.to(x.dtype), a_w.to(x.dtype)
        return torch.matmul(torch.matmul(a_h, x), a_w.t())
    # (N,C,h,w) --A_h--> (N,C,H,w) --A_wᵀ--> (N,C,H,W)
    y = torch.matmul(torch.matmul(a_h, x.float()), a_w.t())
    return y.to(x.dtype)
