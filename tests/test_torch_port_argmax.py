"""The port's upsampled argmax (K1) vs the JAX Pallas kernel run in interpret
mode on the CPU, with the cases and criteria of tests/test_pallas_eval.py.

On CPU tensors the wrapper takes `upsampled_argmax_plain`. The CUDA kernel
itself is compared with that plain version on the card by
tests/test_torch_port_cuda.py and chip_smoke.py; its tiling (row intervals
and column windows, host tables) is checked here.
A mismatch is allowed only where the two chosen classes tie within 1e-5
(the order of float operations differs between the two paths).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.ops.pallas_eval import upsampled_argmax as jax_argmax
from structure_knowledge_distillation_tpu.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.taps import (
    SMEM_MAX,
    tap_intervals,
    tap_tables,
    window_smem_bytes,
)
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    _PX,
    _tiling,
    upsampled_argmax,
    upsampled_argmax_plain,
)


def _both(logits_nhwc: np.ndarray, out_size, dtype=torch.float32):
    """(plain, wrapper) predictions of the port on the NCHW copy of the input."""
    t = torch.from_numpy(np.ascontiguousarray(logits_nhwc.transpose(0, 3, 1, 2))).to(dtype)
    plain = upsampled_argmax_plain(t, out_size).numpy()
    wrapped = upsampled_argmax(t, out_size).numpy()
    assert plain.dtype == wrapped.dtype == np.int32
    return plain, wrapped


def _check_ties(ours, ref, logits_nhwc, out_size, msg=""):
    diff = ours != ref
    if diff.any():
        up = np.asarray(resize_bilinear_align_corners(jnp.asarray(logits_nhwc), out_size))
        ii = np.nonzero(diff)
        gap = np.abs(up[(*ii, ours[diff])] - up[(*ii, ref[diff])])
        assert gap.max() < 1e-5, f"{msg} max tie gap {gap.max()}"


@pytest.mark.parametrize("hin,hout", [((9, 9), (64, 64)), ((13, 17), (32, 64))])
def test_matches_jax_kernel(hin, hout):
    logits = np.random.RandomState(0).randn(2, *hin, 19).astype(np.float32)
    ref = np.asarray(jax_argmax(jnp.asarray(logits), hout))
    for ours in _both(logits, hout):
        assert ours.shape == ref.shape
        assert (ours != ref).mean() < 1e-3
        _check_ties(ours, ref, logits, hout)


def test_bf16_logits():
    logits = np.random.RandomState(1).randn(1, 9, 9, 7).astype(np.float32)
    ref = np.asarray(jax_argmax(jnp.asarray(logits).astype(jnp.bfloat16), (32, 32)))
    for ours in _both(logits, (32, 32), torch.bfloat16):
        assert (ours != ref).mean() < 1e-3


def test_tie_breaks_to_first_index():
    base = np.random.RandomState(2).randn(1, 5, 7, 1).astype(np.float32)
    logits = np.repeat(base, 4, axis=-1)  # all 4 classes tied
    assert (np.asarray(jax_argmax(jnp.asarray(logits), (32, 28))) == 0).all()
    for ours in _both(logits, (32, 28)):
        assert (ours == 0).all()


def test_randomized_sweep():
    """Random shapes and class counts, half of them quantised (coarse value
    grid => many exact ties after interpolation), against the JAX kernel."""
    rng = np.random.RandomState(11)
    for trial in range(6):
        b = int(rng.randint(1, 3))
        hin = (int(rng.randint(4, 16)), int(rng.randint(4, 16)))
        # the JAX kernel's row blocks need h_out % 8 == 0; the port has no such limit
        hout = (8 * int(rng.randint(2, 10)), int(rng.randint(16, 72)))
        c = int(rng.randint(2, 24))
        vals = rng.randn(b, *hin, c).astype(np.float32)
        if trial % 2:
            vals = np.round(vals * 2.0) / 2.0
        ref = np.asarray(jax_argmax(jnp.asarray(vals), hout))
        msg = f"trial {trial}: b={b} in={hin} out={hout} c={c}"
        for ours in _both(vals, hout):
            diff = ours != ref
            assert diff.mean() < 5e-3, f"{msg} mismatch={diff.mean()}"
            _check_ties(ours, ref, vals, hout, msg)


def test_ragged_output_against_jax_resize():
    """No multiple-of-8 constraint on the port's output size."""
    logits = np.random.RandomState(5).randn(1, 7, 11, 5).astype(np.float32)
    out = (37, 53)
    ref = np.asarray(jnp.argmax(resize_bilinear_align_corners(jnp.asarray(logits), out),
                                axis=-1))
    for ours in _both(logits, out):
        assert (ours != ref).mean() < 1e-3
        _check_ties(ours, ref, logits, out)


@pytest.mark.parametrize("bad,err", [
    (torch.zeros(1, 3, 4, 4, dtype=torch.float16), TypeError),
    (torch.zeros(1, 3, 4, 4, dtype=torch.int32), TypeError),
    (torch.zeros(3, 4, 4), ValueError),
    (torch.zeros(1, 1, 3, 4, 4), ValueError),
])
def test_wrapper_rejects_bad_input(bad, err):
    with pytest.raises(err):
        upsampled_argmax(bad, (8, 8))


# (N, C, h, w) -> (H, W): the K1 cases of tests/test_torch_port_cuda.py (the
# eval path's shape among them), chip_smoke.py phase 3's 512² case, and
# (px, ncols) where a case sets them
@pytest.mark.parametrize("shape,out,expect", [
    ((1, 5, 7, 11), (37, 53), None),
    ((2, 19, 13, 17), (100, 130), None),
    ((1, 3, 1, 9), (5, 64), None),
    ((1, 4, 6, 6), (1, 1), (512, 1)),
    ((1, 19, 129, 257), (1024, 2048), (512, 65)),  # the eval path: 4 windows
    ((1, 5, 40, 40), (17, 23), (512, 40)),         # downsampled: one window of every column
    ((3, 7, 19, 23), (101, 157), None),
    ((1, 200, 9, 129), (40, 512), (256, 65)),      # 200 classes: windows halved
    ((2, 19, 65, 65), (512, 512), (512, 65)),
])
def test_argmax_tiling_fits_the_card(shape, out, expect):
    """Every window of px output columns reads at most ncols low-res columns,
    whose staged rows and pairs fit the block's shared memory, and the next
    wider window would not; the row intervals hold every output row once,
    in the interval of its first row tap."""
    _, c, h_in, w_in = shape
    px, ncols = _tiling(c, w_in, out[1])
    assert 1 <= px <= _PX and 1 <= ncols <= w_in
    assert window_smem_bytes(c, ncols) <= SMEM_MAX
    (lo, hi), _ = tap_tables(w_in, out[1])
    reads = [hi[min(x0 + px, out[1]) - 1] - lo[x0] + 1 for x0 in range(0, out[1], px)]
    assert max(reads) == ncols
    if px < _PX:
        wider = [hi[min(x0 + 2 * px, out[1]) - 1] - lo[x0] + 1
                 for x0 in range(0, out[1], 2 * px)]
        assert window_smem_bytes(c, max(wider)) > SMEM_MAX
    start = tap_intervals(h_in, out[0])
    assert start[0] == 0 and start[-1] == out[0] and (np.diff(start) >= 0).all()
    (row_lo, _), _ = tap_tables(h_in, out[0])
    owner = np.repeat(np.arange(h_in), np.diff(start))
    assert np.array_equal(owner, row_lo)
    if expect is not None:
        assert (px, ncols) == expect


def test_argmax_tiling_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="20000 channels"):
        _tiling(20000, 65, 512)
