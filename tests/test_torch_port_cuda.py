"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without a CUDA device: a CUDA
kernel has no CPU mode. On a GPU host:

    python -m pytest tests/test_torch_port_cuda.py -q

The file imports only the port, so it runs where the JAX package's
dependencies are missing. K1 (`upsampled_argmax`) may disagree with its plain
version only where the two chosen classes tie within 1e-5: the two sum the
same two-tap products in another order. Against a tap-by-tap oracle that
rounds as the kernel does, its class map is equal bit for bit.

K2–K5 (`upsampled_ce_loss[_dsn]`, forward and backward) against their plain
versions: the loss to a relative 1e-5 and the low-res gradients to 1e-4 of
their largest entry in f32 (f32 sums in another order), one bf16 ulp of the
largest entry in bf16 (one rounding of the same f32 value, after sums in
another order); two runs are bit-identical (no atomics, fixed-order sums).
The cases include the backward's tiling edges: w_out = 2048, a downsampled
output, intervals of one row and a column split into chunks; and the
forward's: labels outside [0, C) that are not ignored (counted, picking 0)
and classes enough to split the output columns into several windows.

K6–K8 (`fused_bn.bn_act`, `bn_grad_sums`, `bn_grad_input`) against their
plain versions: the same f32 operations in the same order, so the f32
forward agrees to 1e-6 relative (ELU: expm1f) and the bf16 forward to one
bf16 ulp of each value; K7's sums to 1e-5 of their largest entry (f32 sums
in another order); K8's dx to 1e-5 of max|dx| in f32 and one bf16 ulp of
max|dx| in bf16 (the plain version divides by the slope as a multiplication
by its reciprocal); two runs are bit-identical. K9 (`conv3x3`) against
`conv3x3_plain` (cuDNN, TF32 off): 1e-5 of max|out| in f32, 2⁻⁷ of it in
bf16 (one rounding of f32 sums taken in another order). bf16 with Cin a
multiple of 64 and Cout 64 or 128 takes the tensor-core kernel
(`csrc/conv3x3_wgmma.cu`), every other case the direct one
(`csrc/conv3x3.cu`); `pytest -k conv3x3` runs only the K9 tests.

`data.device_prefetch` on the card: the batches arrive equal to the host's
(NCHW images), copied from pinned memory, and a step that overwrites its
inputs in place while the producer runs ahead corrupts no later batch.

The multi-step train loop (`make_train_loop`) on the card, with the small
models of the CPU tests in f32 (TF32 off, cuDNN deterministic): after its
eager warm-up chunk, a chunk captured as a CUDA graph and replayed, then
replayed again, ends where the same steps taken eagerly end, within 1e-5
relative L2 per tensor (the same kernels on the same inputs); and a step
that syncs with the host (`.item()`) makes the capture raise, with no
eager fallback. That test comes last: a failed capture can leave the
process's CUDA state unfit for later tests.

The ESPNet-C, OHEM and remat paths on the card: a small ESPNet-C chunk
(two heads of different shapes: K2/K3 twice a step, no uniform drawn) and
an OHEM chunk (the threshold search without a host sync) each capture and
replay to the eager steps within the same 1e-5; a fused, rematerialised R18
student launches K6 again in each block's recompute and equals the plain
student.
"""

import copy

import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import cast_batches, device_prefetch
from structure_knowledge_distillation_tpu_torch.models import Discriminator, ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops import ABN, fused_bn
from structure_knowledge_distillation_tpu_torch.ops.conv3x3 import _route, conv3x3, conv3x3_plain
from structure_knowledge_distillation_tpu_torch.ops.fused_bn import abn_fused_train
from structure_knowledge_distillation_tpu_torch.ops.resize import resize_bilinear_align_corners
from structure_knowledge_distillation_tpu_torch.ops.taps import tap_tables
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
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


# K1's cases, (N, C, h, w) -> (H, W); tests/test_torch_port_argmax.py checks
# the kernel's tiling of each on the CPU
K1_CASES = [
    ((1, 5, 7, 11), (37, 53)),      # ragged: no multiple of anything
    ((2, 19, 13, 17), (100, 130)),
    ((1, 3, 1, 9), (5, 64)),        # one-row input: lo == hi everywhere
    ((1, 4, 6, 6), (1, 1)),         # one output sample
    ((1, 19, 129, 257), (1024, 2048)),  # the eval path's shape
    ((1, 5, 40, 40), (17, 23)),     # downsampled: empty row intervals, one wide window
    ((3, 7, 19, 23), (101, 157)),   # batch 3, ragged
    ((1, 200, 9, 129), (40, 512)),  # 200 classes: windows halved to 256 columns
]


def _k1_input(shape, dtype, quantised, device):
    vals = np.random.RandomState(9).randn(*shape).astype(np.float32)
    if quantised:  # coarse grid: many exact ties after interpolation
        vals = np.round(vals * 2.0) / 2.0
    return torch.from_numpy(vals).to(device, dtype)


def _tapwise_argmax(x, out):
    """K1's arithmetic tap by tap, as separate torch operations on the card:
    the two row taps of each output row interpolated along H, then the two
    column taps along W (each product and each sum its own kernel, so each is
    rounded on its own: eager torch contracts nothing into an FMA), then the
    first-index argmax over classes."""
    n, c, h_in, w_in = x.shape
    (ylo, yhi), (wy0, wy1) = (torch.from_numpy(a).to(x.device) for a in tap_tables(h_in, out[0]))
    (xlo, xhi), (wx0, wx1) = (torch.from_numpy(a).to(x.device) for a in tap_tables(w_in, out[1]))
    xf = x.float()
    v = xf[:, :, ylo.long()] * wy0[:, None] + xf[:, :, yhi.long()] * wy1[:, None]
    u = v[..., xlo.long()] * wx0 + v[..., xhi.long()] * wx1
    return u.argmax(dim=1).to(torch.int32)


@pytest.mark.parametrize("shape,out", K1_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantised", [False, True])
def test_upsampled_argmax_matches_plain(cuda_device, shape, out, dtype, quantised):
    x = _k1_input(shape, dtype, quantised, cuda_device)
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


@pytest.mark.parametrize("shape,out", K1_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quantised", [False, True])
def test_upsampled_argmax_equals_tapwise_oracle(cuda_device, shape, out, dtype, quantised):
    """The kernel interpolates in the oracle's order with the same roundings,
    so the class maps are equal everywhere, quantised ties included."""
    x = _k1_input(shape, dtype, quantised, cuda_device)
    ours = upsampled_argmax(x, out)
    assert torch.equal(ours, _tapwise_argmax(x, out))


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
    with pytest.raises(ValueError, match="channels"):  # no block holds one column
        upsampled_argmax(torch.zeros(1, 20000, 2, 65, device=cuda_device), (4, 512))
    assert upsampled_argmax.launches == before


CE_GRAD_REL = {torch.float32: 1e-4, torch.bfloat16: 2.0 ** -7}


@pytest.mark.parametrize("shape,out", [
    ((8, 19, 65, 65), (512, 512)),  # the train step's shape
    ((1, 5, 17, 23), (129, 177)),   # ragged
    ((2, 3, 1, 9), (1, 64)),        # one-row input and output
    ((1, 4, 6, 1), (40, 1)),        # one-column input and output
    ((2, 7, 33, 33), (256, 256)),
    ((1, 3, 9, 257), (16, 2048)),   # w_out = 2048: 16 columns per backward block
    ((1, 5, 40, 40), (17, 23)),     # downsampled: empty row intervals and column cells
    ((1, 4, 33, 9), (40, 20)),      # intervals of one high-res row
    ((1, 3, 4, 1), (5, 300)),       # one column of 300 pixels: three chunks per row
    ((2, 200, 9, 65), (16, 128)),   # 2 × 200 classes: forward windows of 64 columns
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("heads", [1, 2])
def test_upsampled_ce_out_of_range_labels(cuda_device, dtype, heads):
    """A label outside [0, C) that is not `ignore` is counted and picks 0:
    its loss is the plain resize's lse alone."""
    shape, out = (2, 5, 17, 23), (129, 177)
    rng = np.random.RandomState(13)
    xs = [torch.from_numpy((2.0 * rng.randn(*shape)).astype(np.float32)).to(cuda_device, dtype)
          for _ in range(heads)]
    labels = rng.randint(0, shape[1], (shape[0],) + out)
    labels[rng.rand(*labels.shape) < 0.05] = 255
    odd = rng.rand(*labels.shape) < 0.1
    labels[odd] = rng.choice([-7, -1, 5, 6, 254, 256, 1000], size=int(odd.sum()))
    lab = torch.from_numpy(labels).to(cuda_device)
    fn = upsampled_ce_loss if heads == 1 else upsampled_ce_loss_dsn
    loss = fn(*xs, lab, out)
    assert torch.equal(loss, fn(*xs, lab, out))

    lab64 = lab.long()
    mask = lab64 != 255
    inside = (lab64 >= 0) & (lab64 < shape[1])
    ref = 0.0
    for w, x in zip((1.0, 0.4), xs):
        up = resize_bilinear_align_corners(x.float(), out).double()
        lse = torch.logsumexp(up, dim=1)
        picked = up.gather(1, torch.where(inside, lab64, 0)[:, None])[:, 0]
        ce = lse - torch.where(inside, picked, torch.zeros_like(picked))
        ref += w * (ce[mask].sum() / mask.sum()).item()
    np.testing.assert_allclose(loss.item(), ref, rtol=1e-5, atol=1e-7)


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


# ------------------------------------------------------------ K6–K8: fused ABN
BN_SHAPES = [
    (2, 5, 7, 9),        # ragged planes: 63 elements, every plane starts unaligned
    (1, 3, 1, 1),        # one element per plane
    (3, 4, 65, 65),      # H·W = 4225: a masked tail in every plane
    (2, 8, 32, 32),      # aligned planes
    (8, 64, 256, 256),   # the stem
    (8, 512, 65, 65),    # R18 layer4
]
PATH_ONLY = {(8, 64, 256, 256), (8, 512, 65, 65)}


def _bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    mag = t.float().abs().clamp_min(1e-30)
    return torch.exp2(torch.floor(torch.log2(mag)) - 7)


def _bn_inputs(shape, dtype, activation, device, seed):
    """x, and a saved output z of that activation (an ELU's lies above −1),
    an incoming gradient with a non-zero mean, and per-channel parameters."""
    g = torch.Generator().manual_seed(seed)
    c = shape[1]
    x = (2.0 * torch.randn(shape, generator=g) + 0.3).to(device, dtype)
    z = fused_bn.bn_act_plain(x.cpu().float(), torch.ones(c), torch.zeros(c), activation)
    if activation == "elu":
        z = z.clamp_min(-0.95)
    z = z.to(device, dtype)
    dz = (torch.randn(shape, generator=g) + 0.5).to(device, dtype)
    prm = [(torch.rand(c, generator=g) + 0.5).to(device) for _ in range(3)]  # gamma, coef, scale
    beta, shift, edz, eydz = [(0.3 * torch.randn(c, generator=g)).to(device) for _ in range(4)]
    return x, z, dz, prm[0], beta, prm[1], edz, eydz, prm[2], shift


def _bn_cases():
    for shape in BN_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            for act in ("none", "leaky_relu", "elu"):
                if shape in PATH_ONLY and (act == "elu" or dtype == torch.float32
                                           and shape[1] == 64):
                    continue
                yield pytest.param(shape, dtype, act, id=f"{shape}-{str(dtype)[6:]}-{act}")


@pytest.mark.parametrize("shape,dtype,activation", list(_bn_cases()))
def test_fused_bn_kernels_match_plain(cuda_device, shape, dtype, activation):
    x, z, dz, gamma, beta, coef, edz, eydz, scale, shift = _bn_inputs(
        shape, dtype, activation, cuda_device, sum(shape))
    before = (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
              fused_bn.bn_grad_input.launches)
    outs = [fused_bn.bn_act(x, scale, shift, activation) for _ in range(2)]
    sums = [fused_bn.bn_grad_sums(z, dz, gamma, beta, activation) for _ in range(2)]
    dxs = {tr: [fused_bn.bn_grad_input(z, dz, gamma, beta, coef, edz, eydz, activation, 0.01, tr)
                for _ in range(2)] for tr in (True, False)}
    assert (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
            fused_bn.bn_grad_input.launches) == (before[0] + 2, before[1] + 2, before[2] + 4)
    ref = fused_bn.bn_act_plain(x, scale, shift, activation)
    ref_sums = fused_bn.bn_grad_sums_plain(z, dz, gamma, beta, activation)
    torch.cuda.synchronize()

    assert torch.equal(outs[0], outs[1]) and outs[0].dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(outs[0], ref, rtol=1e-6, atol=1e-30)
    else:
        assert ((outs[0].float() - ref.float()).abs() <= _bf16_ulp(ref)).all()
    for a, b, r in zip(*sums, ref_sums):
        assert torch.equal(a, b) and a.dtype == torch.float32
        assert (a - r).abs().max().item() <= 1e-5 * r.abs().max().item()
    for training, (d1, d2) in dxs.items():
        r = fused_bn.bn_grad_input_plain(z, dz, gamma, beta, coef, edz, eydz, activation, 0.01,
                                         training)
        assert torch.equal(d1, d2) and d1.dtype == dtype
        scale_max = r.float().abs().max().item()
        tol = 1e-5 * scale_max if dtype == torch.float32 else 2.0 ** -7 * scale_max
        assert (d1.float() - r.float()).abs().max().item() <= tol, training


def test_fused_bn_r101_layer4_eval(cuda_device):
    """K6 at the R101 teacher's layer4 eval shape, bf16, against the plain
    version; the whole of abn_fused_eval under no_grad."""
    g = torch.Generator().manual_seed(3)
    x = torch.randn(8, 2048, 65, 65, generator=g).to(cuda_device, torch.bfloat16)
    w, b, mean = (torch.randn(2048, generator=g).to(cuda_device) for _ in range(3))
    var = (torch.rand(2048, generator=g) + 0.5).to(cuda_device)
    before = fused_bn.bn_act.launches
    with torch.no_grad():
        z = fused_bn.abn_fused_eval(x, w, b, mean, var, 1e-5, "none")
    assert fused_bn.bn_act.launches == before + 1
    _, scale, shift = fused_bn._scale_shift(mean, var, w, b, 1e-5, True)
    ref = fused_bn.bn_act_plain(x, scale, shift, "none")
    assert ((z.float() - ref.float()).abs() <= _bf16_ulp(ref)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("activation", ["none", "leaky_relu", "elu"])
def test_abn_fused_train_cuda_matches_cpu(cuda_device, dtype, activation):
    """The autograd Function on the card (K6 forward, K7 + K8 backward)
    against the same Function on the CPU (the plain versions): the batch
    statistics are torch reductions in another order on each device, so f32
    agrees to 1e-5 and bf16 to 1e-2 of each tensor's largest entry."""
    rng = np.random.RandomState(4)
    shape = (4, 6, 33, 33)
    x = (np.clip(rng.randn(*shape), -3, 3) * 2 + 0.5).astype(np.float32)
    w = (np.where(rng.rand(6) < 0.25, -1.0, 1.0) * (0.5 + 0.5 * rng.rand(6))).astype(np.float32)
    b = (0.3 * rng.randn(6)).astype(np.float32)
    ct = torch.from_numpy(rng.randn(*shape).astype(np.float32))
    res = {}
    before = (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
              fused_bn.bn_grad_input.launches)
    for dev in ("cpu", cuda_device):
        tx = torch.from_numpy(x).to(dev, dtype).requires_grad_()
        tw = torch.from_numpy(w).to(dev).requires_grad_()
        tb = torch.from_numpy(b).to(dev).requires_grad_()
        z, mean, var = abn_fused_train(tx, tw, tb, 1e-5, activation)
        (z.float() * ct.to(dev)).sum().backward()
        res[str(dev)] = [t.detach().float().cpu() for t in (z, mean, var, tx.grad, tw.grad,
                                                            tb.grad)]
    assert (fused_bn.bn_act.launches, fused_bn.bn_grad_sums.launches,
            fused_bn.bn_grad_input.launches) == (before[0] + 1, before[1] + 1, before[2] + 1)
    rel = 1e-5 if dtype == torch.float32 else 1e-2
    for name, ours, ref in zip(("z", "mean", "var", "dx", "dweight", "dbias"),
                               res[str(cuda_device)], res["cpu"]):
        assert (ours - ref).abs().max().item() <= rel * ref.abs().max().item(), name


def test_abn_module_fused_on_cuda(cuda_device):
    mod = ABN(16, activation="leaky_relu", fused=True, device=cuda_device)
    x = torch.randn(2, 16, 9, 11, device=cuda_device)
    before = fused_bn.bn_act.launches
    z = mod.train()(x)
    with torch.no_grad():
        z_eval = mod.eval()(x)
    assert fused_bn.bn_act.launches == before + 2
    assert z.shape == z_eval.shape == x.shape
    assert torch.isfinite(z).all() and torch.isfinite(z_eval).all()
    assert not torch.equal(mod.running_mean, torch.zeros_like(mod.running_mean))


def test_fused_bn_wrapper_checks(cuda_device):
    x = torch.randn(2, 3, 4, 5, device=cuda_device)
    one = torch.ones(3, device=cuda_device)
    with pytest.raises(TypeError):
        fused_bn.bn_act(x.half(), one, one)
    with pytest.raises(ValueError, match="per-channel"):
        fused_bn.bn_act(x, one.cpu(), one)
    # a view at an offset that is not 16-byte aligned is copied, not refused
    view = torch.randn(2 * 3 * 4 * 5 + 1, device=cuda_device)[1:].view(2, 3, 4, 5)
    assert view.data_ptr() % 16 != 0
    torch.testing.assert_close(fused_bn.bn_act(view, one, 0 * one),
                               fused_bn.bn_act_plain(view, one, 0 * one), rtol=0, atol=0)
    before = fused_bn.bn_act.launches
    fused_bn.bn_act(x.cpu(), one.cpu(), one.cpu())  # a CPU tensor takes the plain version
    assert fused_bn.bn_act.launches == before


# ------------------------------------------------------------- K9: conv3x3
@pytest.mark.parametrize("shape,cout", [
    ((1, 7, 9, 3), 5),         # ragged everywhere
    ((2, 16, 40, 20), 40),     # Cin not a multiple of 16, Cout not of 32
    ((1, 1, 1, 16), 32),       # one pixel: all taps but the centre are padding
    ((2, 32, 33, 64), 128),
    ((8, 256, 256, 64), 64),   # the probe's shapes
    ((8, 256, 256, 64), 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv3x3_matches_plain(cuda_device, shape, cout, dtype):
    g = torch.Generator().manual_seed(cout)
    x = torch.randn(shape, generator=g).to(cuda_device, dtype)
    w = (0.1 * torch.randn(3, 3, shape[3], cout, generator=g)).to(cuda_device, dtype)
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before, before_wgmma = conv3x3.launches, conv3x3.wgmma_launches
        out = conv3x3(x, w)
        assert conv3x3.launches == before + 1
        # the f32 and ragged cases take the direct kernel: no wgmma launch
        wgmma = _route(dtype, shape[3], cout) == "wgmma"
        assert conv3x3.wgmma_launches == before_wgmma + wgmma
        ref = conv3x3_plain(x, w)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert out.shape == ref.shape and out.dtype == dtype
    rel = 1e-5 if dtype == torch.float32 else 2.0 ** -7
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= rel * ref.float().abs().max().item(), err


@pytest.mark.parametrize("shape,cout", [
    ((1, 1, 1, 64), 64),        # one pixel: 8 of the 9 taps read only padding
    ((1, 5, 100, 64), 64),      # W < 128: one ragged tile per row
    ((2, 7, 257, 128), 128),    # W = 2·128 + 1: a last tile of one pixel
    ((3, 16, 128, 192), 64),    # three Cin chunks per tap; weights streamed, not resident
    ((2, 9, 130, 128), 128),    # streamed weights at Cout 128
    ((8, 256, 256, 64), 64),    # the probe's shapes
    ((8, 256, 256, 64), 128),
])
def test_conv3x3_wgmma_matches_plain(cuda_device, shape, cout):
    g = torch.Generator().manual_seed(shape[2] + cout)
    x = torch.randn(shape, generator=g).to(cuda_device, torch.bfloat16)
    w = (0.1 * torch.randn(3, 3, shape[3], cout, generator=g)).to(cuda_device, torch.bfloat16)
    assert _route(x.dtype, shape[3], cout) == "wgmma"
    flag = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        before = conv3x3.wgmma_launches
        out = conv3x3(x, w)
        assert conv3x3.wgmma_launches == before + 1
        again = conv3x3(x, w)
        ref = conv3x3_plain(x, w)
        torch.cuda.synchronize()
    finally:
        torch.backends.cudnn.allow_tf32 = flag
    assert out.shape == ref.shape and out.dtype == torch.bfloat16
    assert torch.equal(out, again)  # fixed-order f32 sums: bit-identical runs
    err = (out.float() - ref.float()).abs().max().item()
    assert err <= 2.0 ** -7 * ref.float().abs().max().item(), err


def test_conv3x3_wrapper_checks(cuda_device):
    x = torch.zeros(1, 4, 4, 3, device=cuda_device)
    w = torch.zeros(3, 3, 3, 5, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        conv3x3(x.transpose(1, 2), w)
    with pytest.raises(ValueError):
        conv3x3(x, w.cpu())
    with pytest.raises(TypeError):
        conv3x3(x.half(), w.half())
    xb = torch.zeros(1, 4, 4, 64 + 8, device=cuda_device, dtype=torch.bfloat16)
    wb = torch.zeros(3, 3, 64, 64, device=cuda_device, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="aligned"):  # a view 2 bytes past an aligned base
        conv3x3(xb.view(-1)[1:1 + 16 * 64].view(1, 4, 4, 64), wb)


def _host_batches(n, shape, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 60, shape).astype(np.float32),
             rng.integers(0, 19, shape[:3]).astype(np.int32),
             np.array([shape[1:]] * shape[0]), [f"b{i}_{j}" for j in range(shape[0])])
            for i in range(n)]


@pytest.mark.parametrize("narrow", [False, True], ids=["f32+i32", "bf16+u8"])
def test_device_prefetch_copies_pinned_batches_to_the_card(cuda_device, monkeypatch, narrow):
    pinned = []
    real_pin = torch.Tensor.pin_memory

    def pin_memory(self, *args, **kwargs):
        out = real_pin(self, *args, **kwargs)
        pinned.append(out.is_pinned())
        return out

    monkeypatch.setattr(torch.Tensor, "pin_memory", pin_memory)
    batches = _host_batches(4, (8, 64, 96, 3))
    upstream = iter(batches)
    if narrow:
        upstream = cast_batches(upstream, torch.bfloat16, torch.uint8)
    got = list(device_prefetch(upstream, cuda_device))
    assert pinned == [True] * 2 * len(batches)
    assert len(got) == len(batches)
    for (img, lab, size, names), ref in zip(got, batches):
        assert img.device == lab.device == cuda_device
        assert img.shape == (8, 3, 64, 96) and img.is_contiguous()
        want_img = torch.from_numpy(ref[0]).permute(0, 3, 1, 2)
        want_lab = torch.from_numpy(ref[1])
        if narrow:
            want_img, want_lab = want_img.to(torch.bfloat16), want_lab.to(torch.uint8)
        assert torch.equal(img.cpu(), want_img) and torch.equal(lab.cpu(), want_lab)
        assert size is ref[2] and names is ref[3]


def test_device_prefetch_survives_a_step_that_overwrites_its_inputs(cuda_device):
    """Each 'step' sleeps on the card, then copies its batch and overwrites
    the batch in place; the producer meanwhile stages the next batches on its
    own stream. Without the stream wait or `record_stream`, a later batch
    would land in memory the step still reads, or be read before it lands."""
    batches = _host_batches(6, (8, 256, 256, 3), seed=1)
    kept = []
    for img, lab, *_ in device_prefetch(iter(batches), cuda_device, buffer_size=2):
        torch.cuda._sleep(20_000_000)
        kept.append((img.clone(), lab.clone()))
        img.fill_(float("nan"))
        lab.fill_(-1)
        del img, lab
    torch.cuda.synchronize()
    assert len(kept) == len(batches)
    for (img, lab), ref in zip(kept, batches):
        assert torch.equal(img.cpu(), torch.from_numpy(ref[0]).permute(0, 3, 1, 2))
        assert torch.equal(lab.cpu(), torch.from_numpy(ref[1]))


# --- the multi-step loop on the card (the small models of the CPU tests)
LOOP_K = 2


def _loop_cfg():
    return TrainConfig(classes_num=7, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                       adv_conv_dim=16, num_steps=40, compute_dtype="float32", device="cuda")


def _loop_state(device, student_cls=ResPSPNet) -> KDTrainState:
    cfg = _loop_cfg()
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), 7, width_mult=0.25, generator=g)
    student = student_cls("basic", (1, 1, 1, 1), 7, width_mult=0.25, generator=g)
    disc = Discriminator(7, 1, 33, 16, generator=g)
    teacher.to(device).requires_grad_(False)
    student.to(device)
    disc.to(device)
    return KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def _loop_chunks(device, n, seed=5):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        images = rng.randn(LOOP_K, 2, 3, 256, 256).astype(np.float32)
        images[:, 1] = 3.0 * images[:, 1] + 1.0
        labels = rng.randint(0, 7, (LOOP_K, 2, 256, 256)).astype(np.uint8)
        out.append((torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)))
    return out


@pytest.fixture
def exact_cuda(cuda_device):
    flags = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
             torch.backends.cudnn.deterministic)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    yield cuda_device
    (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
     torch.backends.cudnn.deterministic) = flags


def test_train_loop_replays_equal_eager_steps(exact_cuda):
    state, gen = _loop_state(exact_cuda), torch.Generator().manual_seed(3)
    chunks = _loop_chunks(exact_cuda, 3)
    loop = make_train_loop(_loop_cfg(), LOOP_K)
    loop(state, *chunks[0], LOOP_K, gen)  # eager: the warm-up
    assert loop.graph is None and loop.eager_steps == LOOP_K
    ref, ref_gen = copy.deepcopy(state), torch.Generator().set_state(gen.get_state())
    step = make_train_step(_loop_cfg())
    want = [step(ref, c[0][i], c[1][i], ref_gen) for c in chunks[1:] for i in range(LOOP_K)]
    got = [loop(state, *c, LOOP_K, gen) for c in chunks[1:]]
    torch.cuda.synchronize()
    assert (loop.captures, loop.replays, loop.replayed_steps) == (1, 2, 2 * LOOP_K)
    assert state.step == ref.step == 3 * LOOP_K
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    for j, m in enumerate(want):
        for k, v in m.items():
            torch.testing.assert_close(got[j // LOOP_K][k][j % LOOP_K], v, rtol=1e-5, atol=1e-6)
    for attr in ("student", "discriminator"):
        a, b = getattr(state, attr).state_dict(), getattr(ref, attr).state_dict()
        for k in b:
            err = (a[k].double() - b[k].double()).norm().item()
            assert err <= 1e-5 * max(b[k].double().norm().item(), 1e-12), (attr, k, err)
    for opt, ropt in ((state.g_opt, ref.g_opt), (state.d_opt, ref.d_opt)):
        for p, rp in zip(opt.param_groups[0]["params"], ropt.param_groups[0]["params"]):
            a, b = opt.state[p]["momentum_buffer"], ropt.state[rp]["momentum_buffer"]
            assert (a - b).double().norm() <= 1e-5 * max(b.double().norm().item(), 1e-12)


def test_train_loop_refuses_a_fed_alpha_on_the_card(cuda_device):
    """A fed α is for CPU parity runs: on the card the loop raises rather
    than run the chunk eagerly in the graph's place."""
    state, gen = _loop_state(cuda_device), torch.Generator().manual_seed(3)
    (images, labels), = _loop_chunks(cuda_device, 1)
    loop = make_train_loop(_loop_cfg(), LOOP_K)
    with pytest.raises(ValueError, match="α"):
        loop(state, images, labels, LOOP_K, gen, alpha_k=torch.rand(LOOP_K, 2, 1, 1, 1))
    assert state.step == 0 and loop.eager_steps == 0


def test_train_loop_u8_wire_equals_host_dequantized(exact_cuda):
    """uint8 chunks (the u8 wire) through an eager chunk, a capture of their
    own and its replay: bit for bit the same metrics and state as the same
    chunks de-quantized on the host, through a second loop on a copy of the
    state. The step's mean is on the card before the capture reads it."""
    cfg = _loop_cfg()
    state, gen = _loop_state(exact_cuda), torch.Generator().manual_seed(3)
    ref, ref_gen = copy.deepcopy(state), torch.Generator().set_state(gen.get_state())
    rng = np.random.RandomState(6)
    mean = torch.tensor(cfg.input_mean_bgr, dtype=torch.float32).view(3, 1, 1)
    u8, f32 = [], []
    for _ in range(2):
        images = torch.from_numpy(rng.randint(0, 256, (LOOP_K, 2, 3, 256, 256)).astype(np.uint8))
        labels = torch.from_numpy(rng.randint(0, 7, (LOOP_K, 2, 256, 256)).astype(np.uint8))
        u8.append((images.to(exact_cuda), labels.to(exact_cuda)))
        f32.append(((images.float() - mean).to(exact_cuda), labels.to(exact_cuda)))
    loop, ref_loop = make_train_loop(cfg, LOOP_K), make_train_loop(cfg, LOOP_K)
    got = [loop(state, *c, LOOP_K, gen) for c in u8]
    want = [ref_loop(ref, *c, LOOP_K, ref_gen) for c in f32]
    torch.cuda.synchronize()
    assert (loop.captures, loop.replays) == (ref_loop.captures, ref_loop.replays) == (1, 1)
    assert loop.graph is not None and loop.static_scalars is not None
    for g, w in zip(got, want):
        for k in w:
            assert torch.equal(g[k], w[k]), k
    for attr in ("student", "discriminator"):
        a, b = getattr(state, attr).state_dict(), getattr(ref, attr).state_dict()
        for k in b:
            assert torch.equal(a[k], b[k]), (attr, k)


def _item7_state(device, cfg, student) -> KDTrainState:
    g = torch.Generator().manual_seed(11)
    teacher = ResPSPNet("bottleneck", (1, 1, 1, 1), cfg.classes_num, width_mult=0.25,
                        generator=g)
    disc = Discriminator(cfg.classes_num, 1, 33, 16, generator=g)
    teacher.to(device).requires_grad_(False)
    student.to(device)
    disc.to(device)
    return KDTrainState(
        teacher=teacher, student=student, discriminator=disc,
        g_opt=make_sgd(student.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(disc.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def _replay_equals_eager(device, cfg, state, classes):
    """An eager warm-up chunk, then from copies of the state the next chunk
    eagerly and as a capture + replay; returns the loop."""
    gen = torch.Generator().manual_seed(3)
    rng = np.random.RandomState(8)
    chunks = []
    for _ in range(2):
        images = rng.randn(LOOP_K, 2, 3, 256, 256).astype(np.float32)
        images[:, 1] = 3.0 * images[:, 1] + 1.0
        labels = rng.randint(0, classes, (LOOP_K, 2, 256, 256)).astype(np.uint8)
        chunks.append((torch.from_numpy(images).to(device), torch.from_numpy(labels).to(device)))
    loop = make_train_loop(cfg, LOOP_K)
    loop(state, *chunks[0], LOOP_K, gen)
    ref, ref_gen = copy.deepcopy(state), torch.Generator().set_state(gen.get_state())
    step = make_train_step(cfg)
    want = [step(ref, chunks[1][0][i], chunks[1][1][i], ref_gen) for i in range(LOOP_K)]
    got = loop(state, *chunks[1], LOOP_K, gen)
    torch.cuda.synchronize()
    assert (loop.captures, loop.replays) == (1, 1)
    for i, m in enumerate(want):
        for k, v in m.items():
            assert torch.isfinite(v), k
            torch.testing.assert_close(got[k][i], v, rtol=1e-5, atol=1e-6)
    for attr in ("student", "discriminator"):
        a, b = getattr(state, attr).state_dict(), getattr(ref, attr).state_dict()
        for k in b:
            err = (a[k].double() - b[k].double()).norm().item()
            assert err <= 1e-5 * max(b[k].double().norm().item(), 1e-12), (attr, k, err)
    return loop


def test_train_loop_espnet_replay_equals_eager(exact_cuda):
    """The CamVid recipe's step shape at a small size: an ESPNet-C student
    (p=1, q=2, 11 classes) under the small teacher (33×33 logits resized to
    the student's 32×32), ho false, so a step draws no uniform (an empty
    draw plan); its two heads differ, so each step launches K2 and K3 twice
    and K4/K5 never. The replay equals the eager steps."""
    from structure_knowledge_distillation_tpu_torch.models import ESPNetC

    cfg = TrainConfig(classes_num=11, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                      adv_conv_dim=16, num_steps=40, compute_dtype="float32", device="cuda",
                      student_arch="espnet", ho=False)
    state = _item7_state(exact_cuda, cfg, ESPNetC(11, p=1, q=2,
                                                  generator=torch.Generator().manual_seed(5)))
    for fn, attr in ((upsampled_ce_loss, "launches"), (upsampled_ce_loss, "bwd_launches"),
                     (upsampled_ce_loss_dsn, "launches"), (upsampled_ce_loss_dsn, "bwd_launches")):
        setattr(fn, attr, 0)
    loop = _replay_equals_eager(exact_cuda, cfg, state, 11)
    counts = (upsampled_ce_loss.launches, upsampled_ce_loss.bwd_launches,
              upsampled_ce_loss_dsn.launches, upsampled_ce_loss_dsn.bwd_launches)
    # the warm-up chunk, the reference chunk and the captured one (counted
    # once, as its kernels are recorded): 2 launches a step each
    steps_run = 3 * LOOP_K
    assert counts == (2 * steps_run, 2 * steps_run, 0, 0), counts
    assert loop._plan == []


def test_train_loop_ohem_step_captures(exact_cuda):
    """`ohem` true: the threshold search (softmax, 1/8 zoom, top-k, a device
    `where`) has no host sync, so the chunk captures; the replay equals the
    eager steps. min_kept 6400: k = 100 < the 1/8 grid's 2048 pixels."""
    cfg = TrainConfig(classes_num=7, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                      adv_conv_dim=16, num_steps=40, compute_dtype="float32", device="cuda",
                      ohem=True, ohem_min_kept=6400)
    student = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25,
                        generator=torch.Generator().manual_seed(5))
    _replay_equals_eager(exact_cuda, cfg, _item7_state(exact_cuda, cfg, student), 7)


def test_remat_relaunches_k6_and_equals_plain_on_the_card(exact_cuda):
    """A fused, rematerialised R18 student: its train forward + backward
    launches K6 once more per block ABN (the recompute), and gives the plain
    student's outputs, gradients and running statistics (f32, deterministic
    cuDNN: the recompute runs the same kernels)."""
    x = torch.randn(2, 3, 96, 96, generator=torch.Generator().manual_seed(0)).to(exact_cuda)
    runs = {}
    for remat in (False, True):
        model = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0, bn_fused=True,
                          remat=remat, generator=torch.Generator().manual_seed(4))
        model = model.to(exact_cuda).train()
        fused_bn.bn_act.launches = 0
        outs = model(x)
        fwd = fused_bn.bn_act.launches
        (outs[0].float().square().sum() + outs[1].float().sum()).backward()
        torch.cuda.synchronize()
        runs[remat] = (fwd, fused_bn.bn_act.launches, [o.detach() for o in outs],
                       {k: p.grad for k, p in model.named_parameters()}, model.state_dict())
    (f0, t0, o0, g0, s0), (f1, t1, o1, g1, s1) = runs[False], runs[True]
    assert f0 == t0 == f1 and t1 - f1 == 4 * 3  # 4 BasicBlocks of 3 ABNs each
    for a, b in zip(o0, o1):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
    for k in g0:
        torch.testing.assert_close(g0[k], g1[k], rtol=1e-5, atol=1e-6)
    for k in s0:
        torch.testing.assert_close(s0[k], s1[k], rtol=1e-6, atol=1e-7)


class _SyncingStudent(ResPSPNet):
    """A student whose forward reads a value back to the host: legal in an
    eager step, refused while a CUDA graph is captured."""

    def forward(self, x, draws=None):
        out = super().forward(x, draws)
        out[0].float().sum().item()
        return out


def test_train_loop_capture_raises_on_a_host_sync(cuda_device):
    state, gen = _loop_state(cuda_device, _SyncingStudent), torch.Generator().manual_seed(3)
    chunks = _loop_chunks(cuda_device, 2)
    loop = make_train_loop(_loop_cfg(), LOOP_K)
    loop(state, *chunks[0], LOOP_K, gen)
    with pytest.raises(RuntimeError):
        loop(state, *chunks[1], LOOP_K, gen)
    assert loop.graph is None and loop.replays == 0 and loop.eager_steps == LOOP_K
    assert state.step == LOOP_K
