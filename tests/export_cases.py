"""Shared inputs of tests/test_torch_port_fold.py and
tests/test_torch_port_export.py: ResPSPNet variables made with numpy from a
seed, as the JAX package's tree and the port's state dict.

The full-width R18 student and an R101 teacher at width_mult 0.125 (every
block of its 3-4-23-3 plan), 19 classes, at 64×64 as tests/test_export_cli.py.
Kernels are He-normal (fan-out), conv biases and ABN biases small, ABN
weights signed (a quarter negative, so |w| + eps matters). The running
statistics are calibrated first (one train-mode forward of the port with
momentum 1 on two mean-subtracted raw-range images, the inputs every test
feeds, so eval-mode activations stay O(1) through the 101 layers rather
than growing to 1e5), then scaled ×1.3 + 0.1 as the JAX test does, so that
the fold has something to fold.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
from structure_knowledge_distillation_tpu_torch.ops.batch_norm import ABN
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt

ARCHS = {"r18": ("basic", (2, 2, 2, 2), 1.0), "r101": ("bottleneck", (3, 4, 23, 3), 0.125)}
CLASSES = 19
SIZE = 64
MEAN_BGR = np.array((104.00698793, 116.66876762, 122.67891434), np.float32)


def jax_model(arch: str, **kw) -> JaxResPSPNet:
    block, layers, width = ARCHS[arch]
    return JaxResPSPNet(block=block, layers=layers, num_classes=CLASSES, width_mult=width,
                        **kw)


def port_model(arch: str, **kw) -> ResPSPNet:
    block, layers, width = ARCHS[arch]
    return ResPSPNet(block, layers, CLASSES, width_mult=width,
                     generator=torch.Generator().manual_seed(0), **kw)


def _fill(tree, rng):
    out = {}
    for name, v in tree.items():
        if "kernel" in v:  # a conv: He-normal kernel, small bias
            kh, kw_, _, cout = v["kernel"].shape
            out[name] = {"kernel": (rng.randn(*v["kernel"].shape)
                                    * np.sqrt(2.0 / (kh * kw_ * cout))).astype(np.float32)}
            if "bias" in v:
                out[name]["bias"] = (0.1 * rng.randn(*v["bias"].shape)).astype(np.float32)
        elif "weight" in v:  # an ABN: signed weight, small bias
            shape = v["weight"].shape
            sign = np.where(rng.rand(*shape) < 0.25, -1.0, 1.0)
            out[name] = {"weight": (sign * (rng.rand(*shape) + 0.5)).astype(np.float32),
                         "bias": (0.1 * rng.randn(*shape)).astype(np.float32)}
        else:
            out[name] = _fill(v, rng)
    return out


def variables(arch: str, seed: int = 0) -> dict:
    """The JAX model's {"params", "batch_stats"} as nested dicts of numpy
    arrays (see the module docstring)."""
    rng = np.random.RandomState(seed)
    shapes = jax.eval_shape(lambda: jax_model(arch).init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3), jnp.float32), train=False))
    stats = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes["batch_stats"])
    tree = {"params": _fill(shapes["params"], rng), "batch_stats": stats}

    model = port_model(arch, drop_rate=0.0)
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in tckpt.state_dict_from_jax(tree).items()}, strict=True)
    for m in model.modules():
        if isinstance(m, ABN):
            m.momentum = 1.0
    x = torch.from_numpy(model_input(raw_image(seed + 100, batch=2)))
    with torch.no_grad():
        model.train()(x)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    tree = jax.tree.map(np.asarray, jckpt.import_torch_respspnet(sd, tree))
    tree["batch_stats"] = jax.tree.map(lambda v: (v * 1.3 + 0.1).astype(np.float32),
                                       tree["batch_stats"])
    return tree


def port_state_dict(tree: dict) -> dict:
    """The port's state dict (torch tensors) of a JAX tree."""
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in tckpt.state_dict_from_jax(tree).items()}


def raw_image(seed: int, batch: int = 1, size=(SIZE, SIZE)) -> np.ndarray:
    """A raw (not mean-subtracted) BGR-range f32 image batch, NHWC."""
    return np.random.RandomState(seed).uniform(0.0, 255.0, (batch, *size, 3)).astype(np.float32)


def model_input(image: np.ndarray) -> np.ndarray:
    """A raw NHWC image batch as the model's NCHW input: mean subtracted."""
    return np.ascontiguousarray((image - MEAN_BGR).transpose(0, 3, 1, 2))
