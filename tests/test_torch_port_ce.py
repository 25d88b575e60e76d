"""The port's upsampled cross-entropy and DSN criteria vs the JAX package.

On the CPU the port's `upsampled_ce_loss[_dsn]` take their plain versions
(f32 align-corners resize, then `cross_entropy_ignore`); the JAX side runs its
Pallas kernels K2–K5 in interpret mode, as tests/test_pallas_ce.py does, or
its XLA `criterion_dsn`. Inputs are numpy draws from a seed; logits cross
over NHWC → NCHW.

Tolerances: both sides compute in f32 from the same interpolation weights and
differ only in summation order, so losses agree to rtol 1e-5 and gradients to
1e-4 of their largest entry. With bf16 logits the JAX kernel accumulates the
low-res gradient in bf16 across its row blocks while the port rounds once,
so the gradients agree to 2⁻⁶ of their largest entry (two bf16 ulps).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.losses.task import criterion_dsn as jax_criterion_dsn
from structure_knowledge_distillation_tpu.losses.task import (
    criterion_dsn_fused as jax_criterion_dsn_fused,
)
from structure_knowledge_distillation_tpu.ops.pallas_ce import upsampled_ce_loss as jax_ce
from structure_knowledge_distillation_tpu.ops.pallas_ce import upsampled_ce_loss_dsn as jax_ce_dsn
from structure_knowledge_distillation_tpu_torch.losses import (
    criterion_dsn,
    criterion_dsn_fused,
    cross_entropy_ignore,
)
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import tap_tables
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import (
    _BWD_PX,
    _FWD_PX,
    _FWD_SMEM_MAX,
    _SMEM_MAX,
    _bwd_smem_bytes,
    _bwd_tiling,
    _fwd_smem_bytes,
    _fwd_tiling,
    tap_intervals,
    upsampled_ce_loss,
    upsampled_ce_loss_dsn,
)
from structure_knowledge_distillation_tpu_torch.ops.resize import _interp_matrix_np

LOSS_RTOL = 1e-5
GRAD_REL = {np.float32: 1e-4, "bfloat16": 2.0 ** -6}

# (logits NHWC shape, label size): aligned train-like, and a ragged one whose
# output height has no multiple-of-8 block (the TPU kernel's unaligned path)
CASES = {"aligned": ((2, 33, 33, 7), (256, 256)), "ragged": ((1, 17, 23, 5), (129, 177))}


def _inputs(case, seed, all_ignored=False):
    shape, out = CASES[case]
    rng = np.random.RandomState(seed)
    main = (2.0 * rng.randn(*shape)).astype(np.float32)
    aux = (2.0 * rng.randn(*shape)).astype(np.float32)
    labels = rng.randint(0, shape[-1], (shape[0],) + out).astype(np.int32)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    labels[0, :3] = 255
    if all_ignored:
        labels[:] = 255
    return main, aux, labels, out


def _nchw(a, dtype=torch.float32):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2))).to(dtype)


def _to_nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def _assert_grads(ours, ref, rel, name):
    scale = max(np.abs(ref).max(), 1e-30)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * scale, err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_upsampled_ce_loss_dsn_matches_jax(case, dtype):
    main, aux, labels, out = _inputs(case, 0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jm, ja = jnp.asarray(main, jdt), jnp.asarray(aux, jdt)
    jl = jnp.asarray(labels)
    loss_fn = lambda m, a: jax_ce_dsn(m, a, jl, out, 255, 0.4)  # noqa: E731
    ref, (gm_ref, ga_ref) = jax.value_and_grad(loss_fn, argnums=(0, 1))(jm, ja)
    assert gm_ref.dtype == jdt

    tm = _nchw(np.asarray(jm.astype(jnp.float32)), tdt).requires_grad_()
    ta = _nchw(np.asarray(ja.astype(jnp.float32)), tdt).requires_grad_()
    before = upsampled_ce_loss_dsn.launches
    ours = upsampled_ce_loss_dsn(tm, ta, torch.from_numpy(labels), out)
    ours.backward()
    assert upsampled_ce_loss_dsn.launches == before  # a CPU tensor launches nothing
    assert tm.grad.dtype == tdt
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_RTOL)
    rel = GRAD_REL[np.float32 if dtype == "float32" else "bfloat16"]
    _assert_grads(_to_nhwc(tm.grad), np.asarray(gm_ref, np.float32), rel, "main")
    _assert_grads(_to_nhwc(ta.grad), np.asarray(ga_ref, np.float32), rel, "aux")


@pytest.mark.parametrize("case", sorted(CASES))
def test_upsampled_ce_loss_matches_jax(case):
    main, _, labels, out = _inputs(case, 1)
    jl = jnp.asarray(labels)
    ref, g_ref = jax.value_and_grad(lambda m: jax_ce(m, jl, out, 255))(jnp.asarray(main))
    tm = _nchw(main).requires_grad_()
    ours = upsampled_ce_loss(tm, torch.from_numpy(labels), out)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_RTOL)
    _assert_grads(_to_nhwc(tm.grad), np.asarray(g_ref), GRAD_REL[np.float32], "logits")


def test_all_ignored_labels_give_zero_loss_and_grads():
    main, aux, labels, out = _inputs("aligned", 2, all_ignored=True)
    jl = jnp.asarray(labels)
    ref, grads = jax.value_and_grad(lambda m, a: jax_ce_dsn(m, a, jl, out, 255, 0.4),
                                    argnums=(0, 1))(jnp.asarray(main), jnp.asarray(aux))
    tm, ta = _nchw(main).requires_grad_(), _nchw(aux).requires_grad_()
    ours = upsampled_ce_loss_dsn(tm, ta, torch.from_numpy(labels), out)
    ours.backward()
    assert float(ref) == 0.0 and ours.item() == 0.0
    assert not np.asarray(grads[0]).any() and not tm.grad.any() and not ta.grad.any()


@pytest.mark.parametrize("case", sorted(CASES))
def test_criterion_dsn_matches_jax(case):
    main, aux, labels, out = _inputs(case, 3)
    jl = jnp.asarray(labels)
    ref, grads = jax.value_and_grad(
        lambda m, a: jax_criterion_dsn((m, a), jl, 255), argnums=(0, 1))(
            jnp.asarray(main), jnp.asarray(aux))
    tm, ta = _nchw(main).requires_grad_(), _nchw(aux).requires_grad_()
    ours = criterion_dsn((tm, ta), torch.from_numpy(labels), 255)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_RTOL)
    _assert_grads(_to_nhwc(tm.grad), np.asarray(grads[0]), GRAD_REL[np.float32], "main")
    _assert_grads(_to_nhwc(ta.grad), np.asarray(grads[1]), GRAD_REL[np.float32], "aux")


@pytest.mark.parametrize("same_shape", [True, False])
def test_criterion_dsn_fused_matches_jax(same_shape):
    """Equal heads take the two-head kernel, unequal ones the one-head
    kernel twice, on both sides."""
    main, aux, labels, out = _inputs("aligned", 4)
    if not same_shape:
        aux = aux[:, :17, :21]
    jl = jnp.asarray(labels)
    ref, grads = jax.value_and_grad(
        lambda m, a: jax_criterion_dsn_fused((m, a), jl, 255), argnums=(0, 1))(
            jnp.asarray(main), jnp.asarray(aux))
    tm, ta = _nchw(main).requires_grad_(), _nchw(aux).requires_grad_()
    ours = criterion_dsn_fused((tm, ta), torch.from_numpy(labels), 255)
    ours.backward()
    np.testing.assert_allclose(ours.item(), float(ref), rtol=LOSS_RTOL)
    _assert_grads(_to_nhwc(tm.grad), np.asarray(grads[0]), GRAD_REL[np.float32], "main")
    _assert_grads(_to_nhwc(ta.grad), np.asarray(grads[1]), GRAD_REL[np.float32], "aux")


def test_cross_entropy_ignore_matches_torch():
    rng = np.random.RandomState(5)
    logits = torch.from_numpy(rng.randn(2, 6, 9, 11).astype(np.float32))
    labels = torch.from_numpy(rng.randint(0, 6, (2, 9, 11)))
    labels[0, 0] = 255
    ref = torch.nn.functional.cross_entropy(logits, labels, ignore_index=255)
    np.testing.assert_allclose(cross_entropy_ignore(logits, labels).item(), ref.item(),
                               rtol=1e-6)


SIZE_PAIRS = [(65, 512), (33, 256), (17, 129), (23, 177), (1, 9), (9, 1), (13, 5)]


@pytest.mark.parametrize("n_in,n_out", SIZE_PAIRS)
def test_tap_intervals_partition_the_transposed_interpolation(n_in, n_out):
    """The intervals [start[j], start[j+1]) partition the output samples in
    order; every sample of interval j has a non-zero weight on input j and
    none outside inputs j and j + 1 (the two rows or columns the backward
    kernel stages for interval j)."""
    a = _interp_matrix_np(n_in, n_out)
    start = tap_intervals(n_in, n_out)
    assert start.shape == (n_in + 1,) and start[0] == 0 and start[-1] == n_out
    assert (np.diff(start) >= 0).all()
    for j in range(n_in):
        for y in range(start[j], start[j + 1]):
            cols = np.nonzero(a[y])[0]
            assert a[y, j] != 0 and set(cols) <= {j, j + 1}, (j, y, cols)


@pytest.mark.parametrize("nheads,c,w_in,w_out", [
    (2, 19, 65, 512),   # the train step: 16 columns, one chunk per segment row
    (1, 5, 23, 177), (2, 3, 9, 64), (1, 8, 1, 40), (2, 2, 9, 20), (2, 5, 40, 23),
    (2, 3, 257, 2048),  # w_out = 2048
    (2, 3, 1, 2048),    # one column: its 2048 pixels in chunks
    (2, 150, 65, 512),  # many classes: one column per block
])
def test_bwd_tiling_fits_the_card(nheads, c, w_in, w_out):
    """The backward's tiling stays inside the card's shared memory, and
    where a segment is wider than one column its pixels fit one chunk."""
    c_all = nheads * c
    seg, px, smem = _bwd_tiling(c_all, w_in, w_out)
    assert 1 <= seg <= w_in and 1 <= px <= _BWD_PX
    assert smem == _bwd_smem_bytes(c_all, w_in, seg, px) <= _SMEM_MAX
    start = tap_intervals(w_in, w_out)
    lo = np.arange(0, w_in, seg)
    widest = (start[np.minimum(lo + seg, w_in)] - start[lo]).max()
    assert seg == 1 or widest <= px
    if (c_all, w_in, w_out) == (38, 65, 512):
        assert (seg, px) == (16, 128)


def test_bwd_tiling_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="channels"):
        _bwd_tiling(20000, 65, 512)


# (classes, w_in, w_out) of the 9 shapes of tests/test_torch_port_cuda.py::
# test_upsampled_ce_matches_plain, the train step's first
CARD_CE_SHAPES = [(19, 65, 512), (5, 23, 177), (3, 9, 64), (4, 1, 1), (7, 33, 256),
                  (3, 257, 2048), (5, 40, 23), (4, 9, 20), (3, 1, 300)]


@pytest.mark.parametrize("nheads,c,w_in,w_out,expect", [
    *[(h, *shape, None) for shape in CARD_CE_SHAPES for h in (1, 2)],
    (2, 19, 65, 512, (512, 65)),    # the train step: one window of every column
    (2, 3, 257, 2048, (512, 65)),   # w_out = 2048: four windows
    (2, 3, 1, 2048, (512, 1)),      # one column
    (2, 200, 65, 128, (64, 33)),    # many classes: windows of 64 columns
    (1, 7, 2048, 512, None),        # wide downsampled rows: narrow windows
])
def test_fwd_tiling_fits_the_card(nheads, c, w_in, w_out, expect):
    """Every window of px output columns reads at most ncols low-res columns
    (from its first pixel's first tap to its last pixel's second), and their
    staged rows fit the block's shared memory."""
    c_all = nheads * c
    px, ncols = _fwd_tiling(c_all, w_in, w_out)
    assert 1 <= px <= _FWD_PX and 1 <= ncols <= w_in
    assert _fwd_smem_bytes(c_all, ncols) <= _FWD_SMEM_MAX
    (lo, hi), _ = tap_tables(w_in, w_out)
    reads = [hi[min(x0 + px, w_out) - 1] - lo[x0] + 1 for x0 in range(0, w_out, px)]
    assert max(reads) == ncols
    if px < _FWD_PX:  # the next wider window would not fit
        wider = [hi[min(x0 + 2 * px, w_out) - 1] - lo[x0] + 1 for x0 in range(0, w_out, 2 * px)]
        assert _fwd_smem_bytes(c_all, max(wider)) > _FWD_SMEM_MAX
    if expect is not None:
        assert (px, ncols) == expect


def test_fwd_tiling_refuses_what_no_block_holds():
    with pytest.raises(ValueError, match="channels"):
        _fwd_tiling(20000, 65, 512)
