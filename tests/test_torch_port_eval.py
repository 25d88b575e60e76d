"""The ported eval slice as a whole vs the JAX package, on the CPU.

  * `evaluate_main` of both packages on the same small model and weights over
    two synthetic 64×128 frames, the second with a valid size smaller than
    the output so the in-bounds mask matters: class maps (read back from the
    PNGs both write) agree in ≥ 99.9 % of pixels and mIoU within 1e-3;
  * `cli.eval.main` of both packages on the same fake Cityscapes tree and the
    same `.pth` (torch.save of the JAX `export_torch_respspnet`): the printed
    meanIU agrees within 1e-3.

The JAX side runs its XLA resize + argmax (its kernel is TPU-gated); the
port's CPU path is `upsampled_argmax_plain`. The two differ only in float
association, hence the 99.9 % and 1e-3 bounds rather than equality.
"""

import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from structure_knowledge_distillation_tpu.cli import eval as jax_cli
from structure_knowledge_distillation_tpu.data import SyntheticSegDataset as JaxSynthetic
from structure_knowledge_distillation_tpu.data import batch_iterator as jax_batches
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.models import student_model as jax_student
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu.training.evaluate import evaluate_main as jax_evaluate
from structure_knowledge_distillation_tpu_torch.cli import eval as port_cli
from structure_knowledge_distillation_tpu_torch.data import SyntheticSegDataset, batch_iterator
from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.evaluate import (
    confusion_matrix,
    evaluate_main,
)

SIZE = (64, 128)
CLASSES = 7


class _Cropped:
    """Frame 1 reports a valid (h, w) smaller than the output: the rows and
    columns past it are padding and must not count."""

    def __init__(self, ds):
        self.ds = ds

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        image, label, size, name = self.ds[i]
        if i == 1:
            size = np.array([48, 100, 3])
        return image, label, size, name


def _random_stats(variables, rng):
    stats = jax.tree.map(lambda a: (rng.rand(*a.shape) + 0.5).astype(np.float32),
                         variables["batch_stats"])
    return {"params": jax.tree.map(np.asarray, variables["params"]), "batch_stats": stats}


def _read_png(path):
    from PIL import Image

    with Image.open(path) as im:
        return np.asarray(im)


def test_evaluate_main_matches_jax(tmp_path):
    rng = np.random.RandomState(0)
    jmodel = JaxResPSPNet(block="basic", layers=(1, 1, 1, 1), num_classes=CLASSES,
                          width_mult=0.25)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *SIZE, 3)), train=False)
    variables = _random_stats(variables, rng)

    jds = _Cropped(JaxSynthetic(2, SIZE, CLASSES, seed=3))
    jmiou, jiu = jax_evaluate(jmodel, variables, jax_batches(jds, 1, shuffle=False,
                                                             drop_last=False),
                              CLASSES, out_size=SIZE, output_dir=str(tmp_path / "jax"))

    model = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25)
    sd = tckpt.state_dict_from_jax(variables)
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in sd.items()}, strict=True)
    model.eval()
    ds = _Cropped(SyntheticSegDataset(2, SIZE, CLASSES, seed=3))
    miou, iu, conf = evaluate_main(model, batch_iterator(ds, 1, shuffle=False, drop_last=False),
                                   CLASSES, out_size=SIZE, output_dir=str(tmp_path / "port"),
                                   device="cpu")

    # the confusion counts exactly the in-bounds, non-ignore pixels
    expect = 0
    for i in range(2):
        _, label, size, _ = ds[i]
        expect += int((label[: size[0], : size[1]] != 255).sum())
    assert conf.dtype == np.int64 and int(conf.sum()) == expect
    assert abs(miou - jmiou) <= 1e-3
    np.testing.assert_allclose(iu, jiu, atol=1e-3)
    for i in range(2):
        ours = _read_png(tmp_path / "port" / f"synthetic_{i}.png")
        ref = _read_png(tmp_path / "jax" / f"synthetic_{i}.png")
        assert ours.shape == ref.shape == SIZE
        assert (ours == ref).mean() >= 0.999


def test_confusion_matrix_counts_and_ignore():
    pred = torch.tensor([[0, 1, 2], [2, 2, 0]])
    label = torch.tensor([[0, 1, 255], [2, 0, 0]])
    conf = confusion_matrix(pred, label, 3)
    assert conf.dtype == torch.int64
    np.testing.assert_array_equal(conf.numpy(), [[2, 0, 1], [0, 1, 0], [0, 0, 1]])


def _write_png(path, arr):
    import cv2

    os.makedirs(os.path.dirname(path), exist_ok=True)
    assert cv2.imwrite(path, arr)


def _fake_cityscapes(root, n=2):
    rng = np.random.RandomState(7)
    lines = []
    for i in range(n):
        img = f"leftImg8bit/val/city/f{i}_leftImg8bit.png"
        lab = f"gtFine/val/city/f{i}_gtFine_labelIds.png"
        _write_png(os.path.join(root, img), rng.randint(0, 256, (*SIZE, 3)).astype(np.uint8))
        _write_png(os.path.join(root, lab), rng.randint(0, 34, SIZE).astype(np.uint8))
        lines.append(f"{img}\t{lab}\n")
    lst = os.path.join(root, "val.lst")
    with open(lst, "w") as f:
        f.writelines(lines)
    return lst


def _meaniu(out: str) -> float:
    return float(re.search(r"meanIU: ([0-9.]+)", out).group(1))


def test_cli_eval_matches_jax(tmp_path, capsys):
    root = str(tmp_path / "cityscapes")
    lst = _fake_cityscapes(root)
    jmodel = jax_student(19)
    variables = jmodel.init(jax.random.PRNGKey(1), jnp.zeros((1, *SIZE, 3)), train=False)
    variables = _random_stats(variables, np.random.RandomState(1))
    pth = str(tmp_path / "student.pth")
    torch.save({k: torch.tensor(v)
                for k, v in jckpt.export_torch_respspnet(variables).items()}, pth)

    args = ["--data-dir", root, "--data-list", lst, "--eval-size", "64,128",
            "--resume-from", pth]
    jax_cli.main(args)
    jax_out = capsys.readouterr().out
    port_cli.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert abs(_meaniu(port_out) - _meaniu(jax_out)) <= 1e-3


def test_cli_eval_refuses_what_is_not_ported(tmp_path):
    lst = _fake_cityscapes(str(tmp_path), n=1)
    base = ["--data-dir", str(tmp_path), "--data-list", lst, "--device", "cpu"]
    with pytest.raises(NotImplementedError, match="ROADMAP 'Not ported'"):
        port_cli.main(base + ["--num-spatial-shards", "2"])
    with pytest.raises(ValueError, match=".pth"):
        port_cli.main(base + ["--resume-from", "x.msgpack"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--device cpu"):
            port_cli.main(base[:-2])
