"""The networks of the benchmark's reference, as plain functions of a state dict.

Written from the published descriptions and the recipe, not from the program:
  * PSPNet on a dilated ResNet (Zhao et al., CVPR'17; the KD paper's teacher
    R101 and student R18): a 3-conv stem (3→64→64→128, the first stride 2),
    a ceil-mode 3×3/2 max pool, layers 1–4 with layer3 dilated 2 and layer4
    dilated 4 (output stride 8), the pyramid pool over bins 1, 2, 3, 6
    (adaptive average pool, 1×1 conv, ABN with leaky ReLU, align-corners
    upsample), the concat of the four priors and the input, a 3×3
    bottleneck conv, ABN, channel dropout, a 1×1 head; the DSN head on
    layer3 (3×3 conv with bias, ABN leaky, dropout, 1×1 conv);
  * ABN, the in-place activated BN of the recipe: γ = |weight| + eps,
    biased batch statistics in train mode, running statistics moved with
    momentum 0.1 and a Bessel-corrected variance;
  * ESPNet-C (Mehta et al., ECCV'18), p = 2, q = 8: ESP blocks of a
    reduction conv, five dilated 3×3 branches (d = 1, 2, 4, 8, 16) with
    hierarchical feature fusion, ABN + PReLU, input reinforcement by 3×3/2
    average pools, stride-8 logits and a stride-4 auxiliary head;
  * the SAGAN discriminator of the Ho term (Zhang et al., 2019): BN over the
    score map, spectral-norm 4×4/2 convs with leaky ReLU 0.1, self-attention
    after l3 and after l4, a 4×4 valid conv to one score.
The state-dict keys are the reference repository's torch names (ESPNet-C's
are the program's own, as the reference has no ESPNet checkpoint). Every
convolution and matmul runs in float32 on operands, and gives a result,
passed through `prec`, the rounding of `precision.py`, as are the ABNs'
outputs and the residual sums: the places where a network computing in a
narrower type stores its activations.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

__all__ = ["Ctx", "psp_spec", "espnet_spec", "disc_spec", "psp_forward", "espnet_forward",
           "disc_forward", "disc_keys"]

EPS = 1e-5
BN_MOMENTUM = 0.1
LEAKY = 0.01
DROP = 0.1


class Ctx:
    """One forward's setting: the parameters `p`, the rounding `prec`,
    train or eval mode, the uniform source `draws` (shape → U[0, 1)) of the
    dropouts, and the running statistics' momentum. A train-mode forward
    writes the new running statistics (and spectral u, v) into `p`."""

    def __init__(self, p: Dict[str, torch.Tensor], prec: Callable, train: bool,
                 draws: Optional[Callable] = None, momentum: float = BN_MOMENTUM):
        self.p, self.prec, self.train, self.draws = p, prec, train, draws
        self.momentum = momentum


def conv(c: Ctx, x, name, stride=1, padding=0, dilation=1):
    w = c.p[name + ".weight"]
    b = c.p.get(name + ".bias")
    return c.prec(F.conv2d(c.prec(x), c.prec(w), b, stride, padding, dilation))


def abn(c: Ctx, x, name, act="none", abs_gamma=True):
    w, b = c.p[name + ".weight"], c.p[name + ".bias"]
    gamma = w.abs() + EPS if abs_gamma else w
    if c.train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean.view(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = c.momentum
            c.p[name + ".running_mean"] = (1 - m) * c.p[name + ".running_mean"] + m * mean
            c.p[name + ".running_var"] = ((1 - m) * c.p[name + ".running_var"]
                                          + m * var * n / max(n - 1, 1))
    else:
        mean, var = c.p[name + ".running_mean"], c.p[name + ".running_var"]
    v = lambda t: t.view(1, -1, 1, 1)  # noqa: E731
    y = (x - v(mean)) / torch.sqrt(v(var) + EPS) * v(gamma) + v(b)
    return c.prec(F.leaky_relu(y, LEAKY) if act == "leaky_relu" else y)


def dropout(c: Ctx, x):
    if not c.train:
        return x
    u = c.draws((x.shape[0], x.shape[1], 1, 1)).to(x.device)
    return torch.where(u < 1.0 - DROP, x / (1.0 - DROP), torch.zeros_like(x))


def up(x, size):
    return F.interpolate(x, size=size, mode="bilinear", align_corners=True)


# ----------------------------------------------------------------- PSPNet
def _psp_plan(block: str, layers):
    """(name, cin, planes, stride, dilation, has_downsample) of every block,
    and the widths (c3, c4, mid) of the heads."""
    exp = 4 if block == "bottleneck" else 1
    plan, inplanes = [], 128
    for li, ((planes, stride, dil), n) in enumerate(
            zip([(64, 1, 1), (128, 2, 1), (256, 1, 2), (512, 1, 4)], layers), start=1):
        for bi in range(n):
            down = bi == 0 and (stride != 1 or inplanes != planes * exp)
            plan.append((f"layer{li}.{bi}", inplanes, planes, stride if bi == 0 else 1, dil,
                         down))
            inplanes = planes * exp
    return plan, (256 * exp, 512 * exp, 512 if block == "bottleneck" else 128)


def psp_spec(block: str, layers, classes: int) -> dict:
    """The parameter layout of a PSPNet: its convolutions (name, cout, cin,
    k, bias), its ABNs (name, channels) and the forward's settings."""
    exp = 4 if block == "bottleneck" else 1
    convs, bns = [], []

    def cv(name, cout, cin, k, bias=False):
        convs.append((name, cout, cin, k, bias))

    for i, (cin, cout) in enumerate([(3, 64), (64, 64), (64, 128)], start=1):
        cv(f"conv{i}", cout, cin, 3)
        bns.append((f"bn{i}", cout))
    plan, (c3, c4, mid) = _psp_plan(block, layers)
    for name, cin, planes, _, _, down in plan:
        if block == "bottleneck":
            cv(f"{name}.conv1", planes, cin, 1)
            cv(f"{name}.conv2", planes, planes, 3)
            cv(f"{name}.conv3", planes * 4, planes, 1)
            bns += [(f"{name}.bn1", planes), (f"{name}.bn2", planes), (f"{name}.bn3", planes * 4)]
        else:
            cv(f"{name}.conv1", planes, cin, 3)
            cv(f"{name}.conv2", planes, planes, 3)
            bns += [(f"{name}.bn1", planes), (f"{name}.bn2", planes)]
        if down:
            cv(f"{name}.downsample.0", planes * exp, cin, 1)
            bns.append((f"{name}.downsample.1", planes * exp))
    for i in range(4):
        cv(f"pspmodule.stages.{i}.1", mid, c4, 1)
        bns.append((f"pspmodule.stages.{i}.2", mid))
    cv("pspmodule.bottleneck.0", mid, c4 + 4 * mid, 3)
    bns.append(("pspmodule.bottleneck.1", mid))
    cv("head", classes, mid, 1, True)
    cv("dsn.0", mid, c3, 3, True)
    bns.append(("dsn.1", mid))
    cv("dsn.3", classes, mid, 1, True)
    return {"kind": "psp", "block": block, "layers": tuple(layers), "classes": classes,
            "convs": convs, "bns": bns, "classifiers": ["head", "dsn.3"]}


def psp_forward(c: Ctx, spec: dict, x: torch.Tensor):
    """(logits, dsn logits, feature after the PSP) of NCHW images."""
    block = spec["block"]
    plan, _ = _psp_plan(block, spec["layers"])
    for i, stride in ((1, 2), (2, 1), (3, 1)):
        x = F.relu(abn(c, conv(c, x, f"conv{i}", stride, 1), f"bn{i}"))
    x = F.max_pool2d(x, 3, 2, 1, ceil_mode=True)
    x3 = None
    for name, _, _, stride, dil, down in plan:
        res = abn(c, conv(c, x, f"{name}.downsample.0", stride), f"{name}.downsample.1") \
            if down else x
        if block == "bottleneck":
            o = F.relu(abn(c, conv(c, x, f"{name}.conv1"), f"{name}.bn1"))
            o = F.relu(abn(c, conv(c, o, f"{name}.conv2", stride, dil, dil), f"{name}.bn2"))
            o = abn(c, conv(c, o, f"{name}.conv3"), f"{name}.bn3")
        else:
            o = F.relu(abn(c, conv(c, x, f"{name}.conv1", stride, dil, dil), f"{name}.bn1"))
            o = abn(c, conv(c, o, f"{name}.conv2", 1, dil, dil), f"{name}.bn2")
        x = F.relu(c.prec(o + res))
        if name.startswith("layer3."):
            x3 = x
    d = abn(c, conv(c, x3, "dsn.0", 1, 1), "dsn.1", "leaky_relu")
    dsn = conv(c, dropout(c, d), "dsn.3")
    h, w = x.shape[2:]
    priors = []
    for i, s in enumerate((1, 2, 3, 6)):
        pooled = F.adaptive_avg_pool2d(x, (s, s))
        pr = abn(c, conv(c, pooled, f"pspmodule.stages.{i}.1"), f"pspmodule.stages.{i}.2",
                 "leaky_relu")
        priors.append(up(pr, (h, w)))
    f = conv(c, torch.cat(priors + [x], dim=1), "pspmodule.bottleneck.0", 1, 1)
    feat = dropout(c, abn(c, f, "pspmodule.bottleneck.1", "leaky_relu"))
    return conv(c, feat, "head"), dsn, feat


# ---------------------------------------------------------------- ESPNet-C
def _esp_widths(features: int, k: int = 5):
    d = features // k
    return [features - d * (k - 1)] + [d] * (k - 1)


def espnet_spec(classes: int, p: int = 2, q: int = 8) -> dict:
    convs, bns, prelus = [], [], []

    def esp(name, cin, features, down):
        widths = _esp_widths(features)
        convs.append((f"{name}.reduce", widths[0], cin, 3 if down else 1, False))
        for i, wd in enumerate(widths):
            convs.append((f"{name}.spp_{i}", wd, widths[0], 3, False))
        bns.append((f"{name}.bn", features))
        prelus.append((f"{name}.act", features))

    convs.append(("level1.conv", 16, 3, 3, False))
    bns.append(("level1.bn", 16))
    prelus.append(("level1.act", 16))
    bns.append(("br1.bn", 19))
    prelus.append(("br1.act", 19))
    esp("level2_down", 19, 64, True)
    for i in range(p):
        esp(f"level2_{i}", 64, 64, False)
    bns.append(("br2.bn", 131))
    prelus.append(("br2.act", 131))
    esp("level3_down", 131, 128, True)
    for i in range(q):
        esp(f"level3_{i}", 128, 128, False)
    bns.append(("br3.bn", 256))
    prelus.append(("br3.act", 256))
    convs.append(("classifier", classes, 256, 1, True))
    convs.append(("aux_classifier", classes, 131, 1, True))
    return {"kind": "espnet", "p": p, "q": q, "classes": classes, "convs": convs, "bns": bns,
            "prelus": prelus, "classifiers": ["classifier", "aux_classifier"]}


def _prelu(c: Ctx, x, name):
    a = c.p[name + ".alpha"].view(1, -1, 1, 1)
    return torch.where(x >= 0, x, x * a)


def _esp(c: Ctx, x, name, features, down, residual):
    widths = _esp_widths(features)
    r = conv(c, x, f"{name}.reduce", 2 if down else 1, 1 if down else 0)
    fused = [conv(c, r, f"{name}.spp_0", 1, 1, 1)]
    for i, dil in enumerate((2, 4, 8, 16), start=1):
        prev = fused[-1]
        add = prev[:, -widths[i]:] if prev.shape[1] != widths[i] else prev
        fused.append(conv(c, r, f"{name}.spp_{i}", 1, dil, dil) + add)
    out = torch.cat(fused, dim=1)
    if residual and out.shape == x.shape:
        out = out + x
    return _prelu(c, abn(c, out, f"{name}.bn"), f"{name}.act")


def espnet_forward(c: Ctx, spec: dict, x: torch.Tensor):
    """(logits at stride 8, aux logits at stride 4, the stride-8 feature)."""
    pool = lambda t: F.avg_pool2d(t, 3, 2, 1, count_include_pad=True)  # noqa: E731
    x1, x2 = pool(x), pool(pool(x))
    l1 = _prelu(c, abn(c, conv(c, x, "level1.conv", 2, 1), "level1.bn"), "level1.act")
    l1c = _prelu(c, abn(c, torch.cat([l1, x1], 1), "br1.bn"), "br1.act")
    l2d = _esp(c, l1c, "level2_down", 64, True, False)
    h = l2d
    for i in range(spec["p"]):
        h = _esp(c, h, f"level2_{i}", 64, False, True)
    l2c = _prelu(c, abn(c, torch.cat([h, l2d, x2], 1), "br2.bn"), "br2.act")
    l3d = _esp(c, l2c, "level3_down", 128, True, False)
    h = l3d
    for i in range(spec["q"]):
        h = _esp(c, h, f"level3_{i}", 128, False, True)
    l3c = _prelu(c, abn(c, torch.cat([h, l3d], 1), "br3.bn"), "br3.act")
    return conv(c, l3c, "classifier"), conv(c, l2c, "aux_classifier"), l3c


# ------------------------------------------------------- SAGAN discriminator
def disc_spec(classes: int, image_size: int, conv_dim: int) -> dict:
    sn = [("l1", conv_dim, classes), ("l2", conv_dim * 2, conv_dim),
          ("l3", conv_dim * 4, conv_dim * 2)]
    width = conv_dim * 4
    attn = [("attn1", conv_dim * 4)]
    if image_size == 65:
        sn.append(("l4", conv_dim * 8, conv_dim * 4))
        width = conv_dim * 8
    attn.append(("attn2", width))
    return {"kind": "disc", "classes": classes, "image_size": image_size, "sn": sn,
            "attn": attn, "width": width}


def _l2n(v):
    return v / (torch.linalg.vector_norm(v) + 1e-12)


def _sn_weight(c: Ctx, name):
    """One power iteration from the stored u (new u and v kept in train
    mode), then W / σ with σ = uᵀ W v taken with the new u and v."""
    w = c.p[f"{name}.0.module.weight_bar"]
    wm = w.reshape(w.shape[0], -1)
    with torch.no_grad():
        v = _l2n(wm.t() @ c.p[f"{name}.0.module.weight_u"])
        u = _l2n(wm @ v)
    if c.train:
        c.p[f"{name}.0.module.weight_u"], c.p[f"{name}.0.module.weight_v"] = u, v
    return w / (u @ (wm @ v))


def disc_forward(c: Ctx, spec: dict, x: torch.Tensor) -> torch.Tensor:
    """The (N,) scores of (N, classes, s, s) score maps. In train mode the
    spectral u and v and the BN's running statistics are updated in `c.p`."""
    x = abn(c, x, "preprocess_additional", abs_gamma=False)
    for name, _, _ in spec["sn"]:
        w = _sn_weight(c, name)
        x = c.prec(F.conv2d(c.prec(x), c.prec(w), c.p[f"{name}.0.module.bias"], 2, 1))
        x = F.leaky_relu(x, 0.1)
        if name in ("l3", "l4"):
            x = _attention(c, x, "attn1" if name == "l3" else "attn2")
    if spec["image_size"] != 65:
        x = _attention(c, x, "attn2")
    return conv(c, x, "last.0").reshape(-1)


def _attention(c: Ctx, x, name):
    n, ch, h, w = x.shape
    q = conv(c, x, f"{name}.query_conv").reshape(n, -1, h * w)
    k = conv(c, x, f"{name}.key_conv").reshape(n, -1, h * w)
    v = conv(c, x, f"{name}.value_conv").reshape(n, ch, h * w)
    att = torch.softmax(c.prec(torch.bmm(c.prec(q.transpose(1, 2)), c.prec(k))), dim=-1)
    out = c.prec(torch.bmm(c.prec(v), c.prec(att.transpose(1, 2)))).reshape(n, ch, h, w)
    return c.p[f"{name}.gamma"] * out + x


def disc_keys(spec: dict):
    """(name, shape, kind) of every tensor of the discriminator's state."""
    out = [("preprocess_additional.weight", (spec["classes"],), "bn_weight"),
           ("preprocess_additional.bias", (spec["classes"],), "bn_bias"),
           ("preprocess_additional.running_mean", (spec["classes"],), "zeros"),
           ("preprocess_additional.running_var", (spec["classes"],), "ones")]
    for name, cout, cin in spec["sn"]:
        m = f"{name}.0.module."
        out += [(m + "weight_bar", (cout, cin, 4, 4), "lecun"), (m + "bias", (cout,), "bias"),
                (m + "weight_u", (cout,), "unit"), (m + "weight_v", (cin * 16,), "unit")]
    for name, ch in spec["attn"]:
        for sub, cout in (("query_conv", ch // 8), ("key_conv", ch // 8), ("value_conv", ch)):
            out += [(f"{name}.{sub}.weight", (cout, ch, 1, 1), "lecun"),
                    (f"{name}.{sub}.bias", (cout,), "bias")]
        out.append((f"{name}.gamma", (1,), "gamma"))
    out += [("last.0.weight", (1, spec["width"], 4, 4), "lecun"), ("last.0.bias", (1,), "bias")]
    return out


def lecun_scale(shape) -> float:
    return 1.0 / math.sqrt(math.prod(shape[1:]))
