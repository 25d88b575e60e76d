"""The port's conv3x3 routing and the tensor-core kernel's weight layout, on the CPU.

`ops/conv3x3.py::_route` picks the CUDA kernel from the dtype and the channel
counts alone, and `pack_weights` lays HWIO weights out as the tensor-core
kernel (`csrc/conv3x3_wgmma.cu`) reads them. The kernel itself runs only on
the card (`tests/test_torch_port_cuda.py`); here a plain reference that
follows its arithmetic, the 3 rows × Cin/64 chunks × 3 columns of shifted
(pixels × 64) · (64 × Cout) products over zero-padded input, read off the
packed weights, is held against the JAX probe's `pallas_conv3x3`
(interpret mode, loaded by path from `scripts/bench_pallas_conv.py`) and
against `conv3x3_plain`.

Tolerances: f32 to 1e-5 of the largest output (f32 sums in another order);
bf16 to 2⁻⁷ of it (one bf16 rounding of nearly the same f32 sum).
"""

import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from structure_knowledge_distillation_tpu_torch.ops.conv3x3 import (
    _route,
    conv3x3,
    conv3x3_plain,
    pack_weights,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}


def _load_probe():
    path = os.path.join(REPO, "scripts", "bench_pallas_conv.py")
    spec = importlib.util.spec_from_file_location("bench_pallas_conv", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tap_reference(x: torch.Tensor, wp: torch.Tensor) -> torch.Tensor:
    """The tensor-core kernel's sum in its order: for each step (dy, chunk
    of 64 input channels) and each dx, the input shifted by (dy − 1, dx − 1)
    with zeros outside the image, times that tap's packed weights, summed
    in f32. x: (N, H, W, Cin); wp: (9·Cin/64, Cout, 64). Returns f32."""
    n, h, w, cin = x.shape
    chunks = cin // 64
    padded = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n, h, w, wp.shape[1])
    for dy in range(3):
        for c in range(chunks):
            for dx in range(3):
                a = padded[:, dy:dy + h, dx:dx + w, 64 * c:64 * c + 64]
                acc += a @ wp[(dy * chunks + c) * 3 + dx].float().T
    return acc


def _close_rel(got, ref, rel):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    err = np.abs(got - ref).max()
    assert err <= rel * np.abs(ref).max(), (err, np.abs(ref).max())


@pytest.mark.parametrize("dtype,cin,cout,route", [
    (torch.bfloat16, 64, 64, "wgmma"),     # the probe's shapes
    (torch.bfloat16, 64, 128, "wgmma"),
    (torch.bfloat16, 192, 64, "wgmma"),    # Cin: any multiple of 64
    (torch.bfloat16, 512, 128, "wgmma"),
    (torch.bfloat16, 3, 64, "direct"),     # an RGB input
    (torch.bfloat16, 96, 64, "direct"),    # Cin not a multiple of 64
    (torch.bfloat16, 64, 32, "direct"),    # Cout outside {64, 128}
    (torch.bfloat16, 64, 256, "direct"),
    (torch.bfloat16, 20, 40, "direct"),
    (torch.float32, 64, 64, "direct"),     # f32 stays on the direct kernel
    (torch.float32, 64, 128, "direct"),
    (torch.float32, 192, 64, "direct"),
])
def test_route_by_dtype_and_channels(dtype, cin, cout, route):
    assert _route(dtype, cin, cout) == route


@pytest.mark.parametrize("cin,cout", [(64, 64), (128, 128), (192, 64)])
def test_pack_weights_layout(cin, cout):
    w = torch.from_numpy(np.random.RandomState(cin + cout).randn(3, 3, cin, cout)
                         .astype(np.float32))
    wp = pack_weights(w)
    chunks = cin // 64
    assert wp.shape == (9 * chunks, cout, 64) and wp.is_contiguous()
    for k in range(9 * chunks):
        step, dx = divmod(k, 3)
        dy, c = divmod(step, chunks)
        assert torch.equal(wp[k], w[dy, dx, 64 * c:64 * c + 64].T)


def test_pack_weights_needs_whole_chunks():
    with pytest.raises(ValueError, match="multiple of 64"):
        pack_weights(torch.zeros(3, 3, 96, 64))


@pytest.mark.parametrize("cout", [64, 128])
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_tap_reference_matches_probe_and_plain(cout, dtype):
    """(1,32,16,64) → Cout: the probe needs H % 16 == 0."""
    jdt, tdt = DTYPES[dtype]
    rng = np.random.RandomState(cout)
    x = rng.randn(1, 32, 16, 64).astype(np.float32)
    w = (0.1 * rng.randn(3, 3, 64, cout)).astype(np.float32)
    xt, wt = torch.from_numpy(x).to(tdt), torch.from_numpy(w).to(tdt)
    ours = _tap_reference(xt, pack_weights(wt)).to(tdt).float().numpy()
    probe = _load_probe().pallas_conv3x3(jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    _close_rel(ours, np.asarray(probe.astype(jnp.float32)), REL[dtype])
    _close_rel(ours, conv3x3_plain(xt, wt).float().numpy(), REL[dtype])


def test_tap_reference_ragged_and_multi_chunk():
    """Borders of a W that is no multiple of anything, three chunks per tap."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 5, 7, 192).astype(np.float32))
    w = torch.from_numpy((0.1 * rng.randn(3, 3, 192, 64)).astype(np.float32))
    _close_rel(_tap_reference(x, pack_weights(w)), conv3x3_plain(x, w), REL["float32"])


def test_cpu_bf16_takes_plain_and_launches_nothing():
    rng = np.random.RandomState(4)
    x = torch.from_numpy(rng.randn(1, 4, 6, 64).astype(np.float32)).to(torch.bfloat16)
    w = torch.from_numpy((0.1 * rng.randn(3, 3, 64, 64)).astype(np.float32)).to(torch.bfloat16)
    before = (conv3x3.launches, conv3x3.wgmma_launches)
    assert torch.equal(conv3x3(x, w), conv3x3_plain(x, w))
    assert (conv3x3.launches, conv3x3.wgmma_launches) == before
