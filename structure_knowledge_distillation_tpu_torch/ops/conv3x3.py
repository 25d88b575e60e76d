"""3×3, stride-1, SAME convolution with no bias (kernel K9).

Counterpart of `scripts/bench_pallas_conv.py`, the JAX package's
feasibility probe of a hand-written stem conv (`pallas_conv3x3`, against
XLA's conv in `xla_conv3x3`). It has no caller in the package; `chip_smoke.py`
runs it as its conv3x3 probe phase. The layout is the probe's at the public
function: x is NHWC, w is HWIO (3, 3, Cin, Cout), float32 or bfloat16 alike;
the sums are f32 and the output is in x's dtype.

`conv3x3` takes `conv3x3_plain` on a CPU tensor. On a CUDA tensor it launches
one of two hand-written CUDA kernels (no cuDNN, cuBLAS or matmul), chosen by
`_route` from the dtype and the channel counts alone:

- "wgmma" (bf16, Cin a multiple of 64, Cout 64 or 128): the implicit GEMM on
  the tensor cores of `csrc/conv3x3_wgmma.cu`, which reads the weights in
  the K-major layout of `pack_weights`;
- "direct" (every other case): the direct convolution on the CUDA cores of
  `csrc/conv3x3.cu`.

`.launches` counts the launches of both kernels, `.wgmma_launches` those of
the tensor-core kernel.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["conv3x3", "conv3x3_plain", "pack_weights"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_TILE_H, _TILE_C = 4, 32  # csrc/conv3x3.cu kTH, kCT: rows and output channels per block
_MAX_GRID_YZ = 65535
_CHUNK = 64  # csrc/conv3x3_wgmma.cu kChunk: input channels per K step
_WGMMA_COUTS = (64, 128)
_WGMMA_TILE_M = 128  # csrc/conv3x3_wgmma.cu kTileM: output pixels per block
_MAX_GRID_X = 2 ** 31 - 1


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The plain version: `F.conv2d` with padding 1 between NHWC permutes,
    the probe's `xla_conv3x3`."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1).contiguous()


def _route(dtype: torch.dtype, cin: int, cout: int) -> str:
    """Which CUDA kernel computes a conv of this dtype and these channel
    counts: "wgmma" or "direct". A pure function of its arguments."""
    if dtype == torch.bfloat16 and cin % _CHUNK == 0 and cout in _WGMMA_COUTS:
        return "wgmma"
    return "direct"


def pack_weights(w: torch.Tensor) -> torch.Tensor:
    """HWIO w (3, 3, Cin, Cout) → the tensor-core kernel's K-major B,
    (9·Cin/64, Cout, 64): entry (dy·Cin/64 + c)·3 + dx holds
    w[dy, dx, 64c:64c + 64, :] transposed, input channels innermost, so the
    three dx taps of the kernel's step (dy, c) lie together."""
    cin, cout = w.shape[2], w.shape[3]
    if cin % _CHUNK:
        raise ValueError(f"pack_weights needs Cin a multiple of {_CHUNK}, got {cin}")
    chunks = cin // _CHUNK
    return (w.reshape(3, 3, chunks, _CHUNK, cout).permute(0, 2, 1, 4, 3)
            .reshape(9 * chunks, cout, _CHUNK).contiguous())


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
    from structure_knowledge_distillation_tpu_torch.ops._build import load_kernels

    lib = load_kernels()  # before the data pointer is read: raises under tracing
    n, h, wd, cin = x.shape
    cout = w.shape[3]
    route = _route(x.dtype, cin, cout)
    if route == "wgmma":
        if n * h * -(-wd // _WGMMA_TILE_M) > _MAX_GRID_X:
            raise ValueError(f"shape beyond the kernel's grid: x {tuple(x.shape)}")
        if x.data_ptr() % 16:
            raise ValueError("x must be 16-byte aligned for the tensor map")
    elif -(-h // _TILE_H) > _MAX_GRID_YZ or n * -(-cout // _TILE_C) > _MAX_GRID_YZ:
        raise ValueError(f"shape beyond the kernel's grid: x {tuple(x.shape)}, Cout {cout}")

    out = torch.empty((n, h, wd, cout), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if route == "wgmma":
            wp = pack_weights(w)
            err = lib.skd_conv3x3_wgmma(x.data_ptr(), wp.data_ptr(), out.data_ptr(), n, h, wd,
                                        cin, cout, stream)
        else:
            err = lib.skd_conv3x3(x.data_ptr(), w.data_ptr(), out.data_ptr(),
                                  _DTYPE_CODES[x.dtype], n, h, wd, cin, cout, stream)
    if err != 0:
        what = "CUresult" if err < 0 else "cudaError"
        raise RuntimeError(f"conv3x3 {route} kernel launch failed: {what} {abs(err)}")
    conv3x3.launches += 1
    if route == "wgmma":
        conv3x3.wgmma_launches += 1
    return out


conv3x3.launches = 0
conv3x3.wgmma_launches = 0
