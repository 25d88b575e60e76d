"""3×3, stride-1, SAME convolution with no bias (kernel K9).

Counterpart of `scripts/bench_pallas_conv.py`, the JAX package's
feasibility probe of a hand-written stem conv (`pallas_conv3x3`, against
XLA's conv in `xla_conv3x3`). It has no caller in the package; `chip_smoke.py`
runs it as its conv3x3 probe phase. The layout is the probe's at the public
function: x is NHWC, w is HWIO (3, 3, Cin, Cout), float32 or bfloat16 alike;
the sums are f32 and the output is in x's dtype.

`conv3x3` launches the hand-written CUDA kernel of `csrc/conv3x3.cu` on a
CUDA tensor (a direct convolution on the CUDA cores; no cuDNN, cuBLAS or
matmul) and takes `conv3x3_plain` on a CPU tensor; `.launches` counts the
kernel launches.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_H, _TILE_C = 4, 32  # csrc/conv3x3.cu kTH, kCT: rows and output channels per block
_MAX_GRID_YZ = 65535


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: `F.conv2d` with padding 1 between NHWC permutes,
    the probe's `xla_conv3x3`."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """SAME 3×3 conv of NHWC x with HWIO w: (N, H, W, Cout) in x's dtype."""
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError(f"expected x (N, H, W, Cin) and w (3, 3, Cin, Cout), got "
                         f"{tuple(x.shape)} and {tuple(w.shape)}")
    if x.dtype not in _DTYPE_CODES or w.dtype != x.dtype:
        raise TypeError(f"x and w must both be float32 or bfloat16, got {x.dtype}, {w.dtype}")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} and w on {w.device}")
    if x.numel() == 0 or w.numel() == 0:
        raise ValueError(f"empty input: x {tuple(x.shape)}, w {tuple(w.shape)}")
    if x.device.type == "cpu":
        return conv3x3_plain(x, w)
    if x.device.type != "cuda":
        raise ValueError(f"no conv3x3 kernel for device {x.device}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("x and w must be contiguous (NHWC, HWIO)")
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    if -(-h // _TILE_H) > _MAX_GRID_YZ or n * -(-cout // _TILE_C) > _MAX_GRID_YZ:
        raise ValueError(f"shape beyond the kernel's grid: x {tuple(x.shape)}, Cout {cout}")

    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()
    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.skd_conv3x3(x.data_ptr(), w.data_ptr(), out.data_ptr(), _DTYPE_CODES[x.dtype],
                              n, h, wd, cin, cout, torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"conv3x3 kernel launch failed: cudaError {err}")
    conv3x3.launches += 1
    return out


conv3x3.launches = 0
