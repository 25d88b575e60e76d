"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. On a GPU host:

    python -m pytest tests/test_torch_port_cuda.py -q

The file imports only the port, so it runs where the JAX package's
dependencies are missing. K1 (`upsampled_argmax`) may disagree with its plain
version only where the two chosen classes tie within 1e-5: the two sum the
same two-tap products in another order.
"""

import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.upsampled_argmax import (
    upsampled_argmax,
    upsampled_argmax_plain,
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
