"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. On a GPU host:

    python -m pytest tests/test_torch_port_cuda.py -q

The file imports only the port, so it runs where the JAX package's
dependencies are missing. K1 (`upsampled_argmax`) may disagree with its plain
version only where the two chosen classes tie within 1e-5: the two sum the
same two-tap products in another order.

K2–K5 (`upsampled_ce_loss[_dsn]`, forward and backward) against their plain
versions: the loss to a relative 1e-5 and the low-res gradients to 1e-4 of
their largest entry in f32 (f32 sums in another order), one bf16 ulp of the
largest entry in bf16 (one rounding of the same f32 value, after sums in
another order); two runs are bit-identical (no atomics, fixed-order sums).
"""

import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    upsampled_argmax,
    upsampled_argmax_plain,
)
from structure_knowledge_distillation_tpu_torch.ops.upsampled_ce import (
    upsampled_ce_loss,
    upsampled_ce_loss_dsn,
    upsampled_ce_loss_dsn_plain,
    upsampled_ce_loss_plain,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("shape,out", [
    ((1, 5, 7, 11), (37, 53)),      # ragged: no multiple of anything
    ((2, 19, 13, 17), (100, 130)),
    ((1, 3, 1, 9), (5, 64)),        # one-row input: lo == hi everywhere
    ((1, 4, 6, 6), (1, 1)),         # one output sample
    ((1, 19, 129, 257), (1024, 2048)),  # the eval path's shape
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantised", [False, True])
def test_upsampled_argmax_matches_plain(cuda_device, shape, out, dtype, quantised):
    vals = np.random.RandomState(9).randn(*shape).astype(np.float32)
    if quantised:  # coarse grid: many exact ties after interpolation
        vals = np.round(vals * 2.0) / 2.0
    x = torch.from_numpy(vals).to(cuda_device, dtype)
    before = upsampled_argmax.launches
    ours = upsampled_argmax(x, out)
    assert upsampled_argmax.launches == before + 1
    ref = upsampled_argmax_plain(x, out)
    torch.cuda.synchronize()
    assert ours.dtype == torch.int32 and ours.shape == ref.shape
    diff = ours != ref
    assert diff.float().mean().item() < 1e-3
    if diff.any():
        up = resize_bilinear_align_corners(x.float(), out)
        gap = (up.gather(1, ours.long()[:, None]) - up.gather(1, ref.long()[:, None]))[:, 0]
        assert gap[diff].abs().max().item() < 1e-5


def test_upsampled_argmax_first_index_on_exact_ties(cuda_device):
    base = torch.randn(1, 1, 5, 7, generator=torch.Generator().manual_seed(2))
    x = base.repeat(1, 4, 1, 1).to(cuda_device)  # all 4 classes tied
    assert (upsampled_argmax(x, (32, 28)) == 0).all()


def test_upsampled_argmax_wrapper_checks(cuda_device):
    x = torch.zeros(1, 3, 8, 6, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        upsampled_argmax(x.transpose(2, 3), (16, 16))
    with pytest.raises(TypeError):
        upsampled_argmax(x.half(), (16, 16))
    before = upsampled_argmax.launches
    upsampled_argmax(x.cpu(), (16, 16))  # a CPU tensor takes the plain version
    assert upsampled_argmax.launches == before


CE_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("shape,out", [
    ((8, 19, 65, 65), (512, 512)),  # the train step's shape
    ((1, 5, 17, 23), (129, 177)),   # ragged
    ((2, 3, 1, 9), (1, 64)),        # one-row input and output
    ((1, 4, 6, 1), (40, 1)),        # one-column input and output
    ((2, 7, 33, 33), (256, 256)),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2])
@pytest.mark.parametrize("ignored", [0.05, 1.0])
def test_upsampled_ce_matches_plain(cuda_device, shape, out, dtype, heads, ignored):
    rng = np.random.RandomState(11)
    xs = [torch.from_numpy((2.0 * rng.randn(*shape)).astype(np.float32)).to(cuda_device, dtype)
          .requires_grad_() for _ in range(heads)]
    labels = rng.randint(0, shape[1], (shape[0],) + out)
    labels[rng.rand(*labels.shape) < ignored] = 255
    labels = torch.from_numpy(labels).to(cuda_device)
    fn, plain = ((upsampled_ce_loss, upsampled_ce_loss_plain) if heads == 1
                 else (upsampled_ce_loss_dsn, upsampled_ce_loss_dsn_plain))
    before = (fn.launches, fn.bwd_launches)
    runs = []
    for _ in range(2):
        loss = fn(*xs, labels, out)
        runs.append((loss.detach(), torch.autograd.grad(loss, xs)))
    assert (fn.launches, fn.bwd_launches) == (before[0] + 2, before[1] + 2)
    ref = plain(*xs, labels, out)
    ref_grads = torch.autograd.grad(ref, xs)
    torch.cuda.synchronize()
    (loss, grads), (loss2, grads2) = runs
    assert torch.equal(loss, loss2) and all(torch.equal(a, b) for a, b in zip(grads, grads2))
    assert loss.dtype == torch.float32 and all(g.dtype == dtype for g in grads)
    np.testing.assert_allclose(loss.item(), ref.item(), rtol=1e-5, atol=1e-7)
    for g, r in zip(grads, ref_grads):
        scale = r.float().abs().max().item()
        err = (g.float() - r.float()).abs().max().item()
        assert err <= CE_GRAD_REL[dtype] * scale + 1e-12, (err, scale)
    if ignored == 1.0:
        assert loss.item() == 0.0 and not any(g.any() for g in grads)


def test_upsampled_ce_wrapper_checks(cuda_device):
    x = torch.zeros(1, 3, 8, 6, device=cuda_device)
    lab = torch.zeros(1, 16, 16, dtype=torch.int64, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        upsampled_ce_loss(x.transpose(2, 3), lab, (16, 16))
    with pytest.raises(TypeError):
        upsampled_ce_loss(x.half(), lab, (16, 16))
    with pytest.raises(ValueError, match="labels"):
        upsampled_ce_loss(x, lab[:, :8], (16, 16))
    with pytest.raises(ValueError, match="agree"):
        upsampled_ce_loss_dsn(x, x[:, :2].contiguous(), lab, (16, 16))
    before = upsampled_ce_loss.launches
    upsampled_ce_loss(x.cpu(), lab.cpu(), (16, 16))  # a CPU tensor takes the plain version
    assert upsampled_ce_loss.launches == before
