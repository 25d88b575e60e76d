"""The inference export, `cli/export.py`: the port's CLI against the JAX
package's `cli/export.py` on the same numpy-seeded R18 variables
(tests/export_cases.py) at 64×64, as tests/test_export_cli.py runs it.

The serving program (`--program-output`, a `torch.export` `.pt2`) is held
against the JAX StableHLO artifact on the CPU platform: class maps may
differ in at most 1e-3 of the pixels (argmax flips at near-ties, the JAX
test's bound), logits within rtol 1e-3 / atol 1e-4.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F
from flax import serialization
from jax import export as jexport

from export_cases import CLASSES, MEAN_BGR, port_model, port_state_dict, raw_image, variables
from structure_knowledge_distillation_tpu.cli.export import main as jax_export_main
from structure_knowledge_distillation_tpu.models.fold import fold_bn_variables
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu_torch.cli.export import export_program, main
from structure_knowledge_distillation_tpu_torch.models import fold_bn_state_dict
from structure_knowledge_distillation_tpu_torch.ops import _build
from structure_knowledge_distillation_tpu_torch.ops.resize import (
    _interp_matrix_np,
    interp_matrix_align_corners,
    resize_bilinear_align_corners,
)
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.evaluate import make_fast_val_fn

MISMATCH_MAX = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The R18 variables as a port `.pth` and a JAX `.msgpack`, and one
    run of the port's CLI with --fold-bn, --torch-output and a classmap
    program at 64×64."""
    d = tmp_path_factory.mktemp("export")
    tree = variables("r18")
    pth, msgpack = str(d / "ckpt.pth"), str(d / "ckpt.msgpack")
    torch.save(port_state_dict(tree), pth)
    with open(msgpack, "wb") as f:
        f.write(serialization.to_bytes(tree))
    out = main(["--checkpoint", pth, "--output", str(d / "infer"), "--fold-bn",
                "--verify-size", "64", "--device", "cpu", "--torch-output", str(d / "ref.pth"),
                "--program-output", str(d / "serve.pt2"), "--program-size", "64,64"])
    return {"dir": d, "tree": tree, "pth": pth, "msgpack": msgpack, "out": out,
            "meta": json.loads((d / "infer.json").read_text())}


def _jax_artifact(setup, name: str, *flags) -> jexport.Exported:
    shlo = str(setup["dir"] / f"{name}.shlo")
    jax_export_main(["--checkpoint", setup["msgpack"], "--output", str(setup["dir"] / name),
                     "--stablehlo-output", shlo, "--stablehlo-size", "64,64",
                     "--stablehlo-platforms", "cpu", *flags])
    with open(shlo, "rb") as f:
        return jexport.deserialize(f.read())


def _program(path):
    return torch.export.load(str(path)).module()


def _run(program, image: np.ndarray) -> np.ndarray:
    with torch.no_grad():
        return program(torch.from_numpy(image)).numpy()


def test_export_cli_folds_and_writes_metadata(setup):
    """--fold-bn: the JSON has the JAX CLI's keys and a parity below 1e-3,
    and `<output>.pth` is the fold of the checkpoint, which loads strictly
    into `ResPSPNet(fold_bn=True)` and equals the JAX fold (carried across
    by `state_dict_from_jax`) within 1 ulp."""
    meta, d = setup["meta"], setup["dir"]
    assert setup["out"] == str(d / "infer") + ".pth"
    assert {k: meta[k] for k in ("arch", "classes_num", "fold_bn", "source")} == {
        "arch": "resnet18", "classes_num": CLASSES, "fold_bn": True, "source": setup["pth"]}
    assert 0.0 <= meta["fold_max_logit_diff"] < 1e-3
    assert meta["program"]["input"] == [1, 64, 64, 3]
    assert meta["program"]["mode"] == "classmap" and meta["program"]["device"] == "cpu"
    assert meta["program"]["bytes"] == os.path.getsize(d / "serve.pt2")

    sd = torch.load(setup["out"], weights_only=True)
    folded = port_model("r18", fold_bn=True)
    folded.load_state_dict(sd, strict=True)
    ref = fold_bn_state_dict(port_state_dict(setup["tree"]))
    jax_ref = tckpt.state_dict_from_jax(fold_bn_variables(setup["tree"]))
    assert list(sd) == list(folded.state_dict()) and set(sd) == set(ref) == set(jax_ref)
    for k, v in sd.items():
        assert torch.equal(v, ref[k]), k
        np.testing.assert_array_max_ulp(v.numpy(), jax_ref[k], maxulp=1)


def test_torch_output_equals_jax_export(setup):
    """--torch-output is the unfolded reference-named state dict: the JAX
    `export_torch_respspnet` of the same variables, key for key."""
    sd = torch.load(str(setup["dir"] / "ref.pth"), weights_only=True)
    ref = jckpt.export_torch_respspnet(setup["tree"])
    assert set(sd) == set(ref)
    for k, v in ref.items():
        np.testing.assert_array_equal(sd[k].numpy(), v, err_msg=k)


def test_program_classmap_matches_jax_stablehlo(setup):
    """The folded classmap `.pt2` against the JAX CLI's folded classmap
    artifact on the same raw image (a batch of two)."""
    image = raw_image(2, batch=2)
    artifact = _jax_artifact(setup, "jax_classmap", "--fold-bn", "--stablehlo-batch", "2")
    want = np.asarray(artifact.call(image))
    main(["--checkpoint", setup["pth"], "--output", str(setup["dir"] / "b2"), "--fold-bn",
          "--verify-size", "64", "--device", "cpu", "--program-output",
          str(setup["dir"] / "b2.pt2"), "--program-size", "64,64", "--program-batch", "2"])
    got = _run(_program(setup["dir"] / "b2.pt2"), image)
    assert got.shape == want.shape == (2, 64, 64) and got.dtype == np.uint8
    assert np.mean(got != want) <= MISMATCH_MAX
    # the batch-1 program of the fixture on the first image
    one = _run(_program(setup["dir"] / "serve.pt2"), image[:1])
    assert np.mean(one != want[:1]) <= MISMATCH_MAX


def test_program_logits_matches_jax_stablehlo(setup):
    """Logits mode, unfolded on both sides: the stride-8 NHWC f32 scores."""
    image = raw_image(3)
    want = np.asarray(_jax_artifact(setup, "jax_logits", "--stablehlo-mode", "logits")
                      .call(image))
    path = str(setup["dir"] / "logits.pt2")
    main(["--checkpoint", setup["pth"], "--output", str(setup["dir"] / "logits"),
          "--device", "cpu", "--program-output", path, "--program-size", "64,64",
          "--program-mode", "logits"])
    got = _run(_program(path), image)
    assert got.shape == want.shape == (1, 9, 9, CLASSES) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_program_loads_without_the_port(setup, tmp_path):
    """The `.pt2` runs in a fresh interpreter where importing the port (or
    JAX) raises, and gives what it gives in this process."""
    image = raw_image(4)
    np.save(tmp_path / "image.npy", image)
    code = (
        "import sys\n"
        "for name in ('structure_knowledge_distillation_tpu_torch',"
        " 'structure_knowledge_distillation_tpu', 'jax', 'flax'):\n"
        "    sys.modules[name] = None\n"
        "import numpy as np, torch\n"
        "prog = torch.export.load(sys.argv[1]).module()\n"
        "with torch.no_grad():\n"
        "    out = prog(torch.from_numpy(np.load(sys.argv[2])))\n"
        "np.save(sys.argv[3], out.numpy())\n"
        "try:\n"
        "    import structure_knowledge_distillation_tpu_torch\n"
        "except ImportError:\n"
        "    print('port blocked')\n"
    )
    proc = subprocess.run([sys.executable, "-c", code, str(setup["dir"] / "serve.pt2"),
                           str(tmp_path / "image.npy"), str(tmp_path / "out.npy")],
                          cwd=str(tmp_path), capture_output=True, text=True, timeout=300,
                          env={**os.environ, "OMP_NUM_THREADS": "2"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "port blocked"
    got = np.load(tmp_path / "out.npy")
    np.testing.assert_array_equal(got, _run(_program(setup["dir"] / "serve.pt2"), image))


def test_program_bf16_matches_eager_bf16(setup):
    """--program-dtype bfloat16: the port's own bf16 folded eager model
    through the same resize and argmax."""
    path = str(setup["dir"] / "bf16.pt2")
    main(["--checkpoint", setup["pth"], "--output", str(setup["dir"] / "bf16"), "--fold-bn",
          "--verify-size", "64", "--device", "cpu", "--program-output", path,
          "--program-size", "64,64", "--program-dtype", "bfloat16"])
    meta = json.loads((setup["dir"] / "bf16.json").read_text())
    assert meta["program"]["dtype"] == "bfloat16"
    image = raw_image(5)
    got = _run(_program(path), image)
    model = port_model("r18", fold_bn=True, dtype=torch.bfloat16).eval()
    model.load_state_dict(torch.load(str(setup["dir"] / "bf16.pth"), weights_only=True))
    x = torch.from_numpy(image - MEAN_BGR).permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        logits = model(x)[0].float()
    want = resize_bilinear_align_corners(logits, (64, 64)).argmax(1).to(torch.uint8).numpy()
    assert np.mean(got != want) <= MISMATCH_MAX


def test_eager_fast_path_unchanged_after_export(setup, tmp_path):
    """Tracing at a shape this process has not run must leave real tensors,
    not the trace's fake ones, in the resize operators' cache: the eager
    fast path at that shape afterwards agrees with F.interpolate + argmax
    and with the program."""
    size = (40, 72)  # stride-8 logits 5×9
    model = port_model("r18", fold_bn=True).eval()
    model.load_state_dict(torch.load(setup["out"], weights_only=True))
    path = str(tmp_path / "p.pt2")
    export_program(model, path, size, 1, "classmap", MEAN_BGR.tolist())
    for n_in, n_out in ((5, 40), (9, 72), (1, 5), (2, 5), (3, 5), (6, 5), (6, 9)):
        t = interp_matrix_align_corners(n_in, n_out, torch.device("cpu"))
        assert type(t) is torch.Tensor, (n_in, n_out, type(t))
        np.testing.assert_array_equal(t.numpy(), _interp_matrix_np(n_in, n_out))

    image = raw_image(6, size=size)
    x = torch.from_numpy(image - MEAN_BGR).permute(0, 3, 1, 2).contiguous()
    label = torch.zeros(size, dtype=torch.uint8)
    with torch.no_grad():
        pred, conf = make_fast_val_fn(model, size, CLASSES)(x, label, *size)
        logits = model(x)[0]
    want = F.interpolate(logits, size, mode="bilinear", align_corners=True).argmax(1)[0]
    assert int(conf.sum()) == size[0] * size[1]
    assert (pred.long() == want).float().mean().item() >= 0.999
    assert np.mean(_run(_program(path), image)[0] != pred.numpy()) <= MISMATCH_MAX


@pytest.mark.parametrize("flags", [["--checkpoint", "ckpt.msgpack", "--device", "cpu"],
                                   ["--checkpoint", "ckpt.pth", "--device", "cuda"]],
                         ids=["msgpack", "cuda-without-cuda"])
def test_export_refuses(flags, monkeypatch, tmp_path):
    """A JAX `.msgpack` raises (the port reads `.pth` only), and so does
    `--device cuda` on a host without CUDA, before anything is written."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    flags = [str(tmp_path / f) if f.startswith("ckpt.") else f for f in flags]
    with pytest.raises((ValueError, RuntimeError), match=r"\.pth checkpoints only|no CUDA"):
        main(flags + ["--output", str(tmp_path / "out")])
    assert not os.listdir(tmp_path)


def test_kernels_refuse_tracing():
    """A kernel wrapper reached while `torch.export` traces raises before any
    ctypes launch (it would read the data pointers of fake tensors)."""
    class Launches(nn.Module):
        def forward(self, x):
            _build.load_kernels()
            return x + 1

    with pytest.raises(RuntimeError, match="cannot be traced"):
        torch.export.export(Launches(), (torch.zeros(2),), strict=False)
