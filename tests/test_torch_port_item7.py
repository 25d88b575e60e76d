"""The CamVid/VOC slice of the port against the JAX package: data sets and
lists, `--remat`, the ESPNet-C cross-family train step, and the CLIs.

  * data: `CamVidDataset`, `VOCDataset` and `VOCTestDataset` give the JAX
    datasets' samples (bit for bit) on fake trees written from a seed, with
    augmentation from one seed; `make_voc_lists`/`make_camvid_lists` write
    the JAX generators' files; the datasets go through the port's
    `batch_iterator` workers and `cast_batches`;
  * remat: a rematerialised R18 student gives the plain one's outputs,
    gradients and running statistics bit for bit on the CPU (the recompute
    replays the same operations), runs the fused ABN's forward again in the
    recompute and updates the statistics once; one remat train step matches
    the JAX remat step within the one-step envelope of
    tests/test_torch_port_train_step.py;
  * the ESPNet-C step: two steps of a small ESPNet-C (p=1, q=2, 11 classes)
    under a small R101-shaped teacher (layers (1,1,1,1), width 0.25) at
    256², whose 33×33 logits are resized to the student's 32×32 (the
    cross-family branch), against the JAX `make_train_step`, both with
    `fused_ce` true (the JAX Pallas K2/K3 in interpret mode, the port's
    plain versions of its kernels: the heads differ, 32×32 and 64×64), with
    that file's tolerances;
  * the CLIs on the CPU: `cli.train --data-set camvid --student-arch espnet`
    (and `--data-set voc`), `cli.eval --data-set voc` against the JAX CLI's
    mIoU, `cli.eval --data-set camvid --student-arch espnet` against the JAX
    CLI on the same weights, `cli.test --data-set voc`, and the CamVid u8
    eval wire against the f32 one.
"""

import json
import math
import os

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization
from PIL import Image
from test_torch_port_train_step import (
    STATE_LEAVES,
    _compare_state,
    _compare_updates,
    _numpy_sd,
    _randomized_vars,
)

from structure_knowledge_distillation_tpu.cli import eval as jax_eval_cli
from structure_knowledge_distillation_tpu.config import TrainConfig as JaxTrainConfig
from structure_knowledge_distillation_tpu.data import camvid as jax_camvid
from structure_knowledge_distillation_tpu.data import lists as jax_lists
from structure_knowledge_distillation_tpu.data import voc as jax_voc
from structure_knowledge_distillation_tpu.models import Discriminator as JaxDiscriminator
from structure_knowledge_distillation_tpu.models import ESPNetC as JaxESPNetC
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.models import student_model as jax_student
from structure_knowledge_distillation_tpu.training import checkpoint as jckpt
from structure_knowledge_distillation_tpu.training import create_train_state
from structure_knowledge_distillation_tpu.training import make_sgd as jax_make_sgd
from structure_knowledge_distillation_tpu.training import make_train_step as jax_make_train_step
from structure_knowledge_distillation_tpu_torch.cli import eval as port_eval_cli
from structure_knowledge_distillation_tpu_torch.cli import test as port_test_cli
from structure_knowledge_distillation_tpu_torch.cli import train as port_train_cli
from structure_knowledge_distillation_tpu_torch.config import TrainConfig
from structure_knowledge_distillation_tpu_torch.data import (
    CAMVID_MEAN,
    CamVidDataset,
    VOCDataset,
    VOCTestDataset,
    batch_iterator,
    cast_batches,
    ensure_list,
    make_camvid_lists,
    make_voc_lists,
)
from structure_knowledge_distillation_tpu_torch.models import (
    Discriminator,
    ESPNetC,
    ResPSPNet,
)
from structure_knowledge_distillation_tpu_torch.ops import fused_bn
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training.evaluate import evaluate_main
from structure_knowledge_distillation_tpu_torch.training.train_state import (
    KDTrainState,
    make_sgd,
    poly_schedule,
)
from structure_knowledge_distillation_tpu_torch.training.train_step import make_train_step

LOSS_RTOL = (2e-3, 5e-2)
LOSS_ATOL = (2e-4, 2e-2)
ESP_CLASSES = 11


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- fake trees
def _blocks(rng, high, h, w, block=8):
    """An (h, w) uint8 map of values < high, constant on block×block tiles."""
    small = rng.integers(0, high, (-(-h // block), -(-w // block)))
    return small.repeat(block, 0).repeat(block, 1)[:h, :w].astype(np.uint8)


def write_fake_camvid(root, splits=(("train", 3), ("val", 2), ("test", 1)), size=(360, 480),
                      seed=0):
    """The SegNet-style CamVid tree: `{split}/*.png` BGR frames and
    `{split}annot/*.png` labels 0..11 in blocks (11 = void)."""
    rng = np.random.default_rng(seed)
    for split, n in splits:
        for i in range(n):
            name = f"{split}_{i:04d}.png"
            image = rng.integers(0, 256, (*size, 3), dtype=np.uint8)
            for sub, arr in ((split, image), (split + "annot", _blocks(rng, 12, *size))):
                os.makedirs(os.path.join(root, sub), exist_ok=True)
                assert cv2.imwrite(os.path.join(root, sub, name), arr)


def write_fake_voc(root, splits=(("train", 3), ("val", 2), ("test", 2)), size=(60, 80),
                   seed=0):
    """A VOC tree: `ImageSets/Segmentation/{split}.txt` ids, `JPEGImages/
    <id>.jpg` frames (the odd ones smaller), `SegmentationClassAug/<id>.png`
    class ids 0..20 in blocks with an ignore (255) border, none for test."""
    rng = np.random.default_rng(seed)
    sets = os.path.join(root, "ImageSets", "Segmentation")
    for d in (sets, os.path.join(root, "JPEGImages"), os.path.join(root, "SegmentationClassAug")):
        os.makedirs(d, exist_ok=True)
    for split, n in splits:
        ids = [f"2007_{split}_{i:03d}" for i in range(n)]
        with open(os.path.join(sets, f"{split}.txt"), "w") as f:
            f.writelines(i + "\n" for i in ids)
        for k, i in enumerate(ids):
            h, w = (size[0] - 8 * (k % 2), size[1] - 12 * (k % 2))
            assert cv2.imwrite(os.path.join(root, "JPEGImages", f"{i}.jpg"),
                               rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
            if split != "test":
                label = _blocks(rng, 21, h, w)
                label[:2] = 255
                assert cv2.imwrite(os.path.join(root, "SegmentationClassAug", f"{i}.png"), label)


@pytest.fixture(scope="module")
def camvid(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("camvid"))
    write_fake_camvid(root)
    return root, make_camvid_lists(root, os.path.join(root, "list"))


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("voc"))
    write_fake_voc(root)
    return root, make_voc_lists(root, os.path.join(root, "list"))


def _same_items(ours, ref, n):
    for i in range(n):
        a, b = ours[i], ref[i]
        assert len(a) == len(b)
        for x, y in zip(a, b):
            if isinstance(x, np.ndarray):
                assert x.dtype == y.dtype and x.shape == y.shape
                np.testing.assert_array_equal(x, y)
            else:
                assert x == y


# ---------------------------------------------------------------- data
@pytest.mark.parametrize("name", ["camvid", "voc"])
def test_lists_equal_jax(tmp_path, name):
    root = str(tmp_path / name)
    (write_fake_camvid if name == "camvid" else write_fake_voc)(root)
    ours = (make_camvid_lists if name == "camvid" else make_voc_lists)(root, str(tmp_path / "a"))
    ref = getattr(jax_lists, f"make_{name}_lists")(root, str(tmp_path / "b"))
    assert sorted(ours) == sorted(ref) == ["test", "train", "val"]
    for split in ours:
        assert os.path.basename(ours[split]) == os.path.basename(ref[split])
        with open(ours[split]) as a, open(ref[split]) as b:
            assert a.read() == b.read()
    # the reference-style default path resolves by generating the lists
    train = "train_aug.txt" if name == "voc" else "train.lst"
    want = str(tmp_path / "dataset" / "list" / name / train)
    assert ensure_list(name, root, want) == want and os.path.isfile(want)


@pytest.mark.parametrize("scale,mirror", [(True, True), (False, False)], ids=["train", "val"])
def test_camvid_dataset_matches_jax(camvid, scale, mirror):
    root, lists = camvid
    kw = dict(crop_size=(128, 160), scale=scale, mirror=mirror, seed=3)
    ours = CamVidDataset(root, lists["train"], max_iters=5, **kw)
    ref = jax_camvid.CamVidDataset(root, lists["train"], max_iters=5, **kw)
    assert len(ours) == len(ref) == 6
    _same_items(ours, ref, len(ours))
    np.testing.assert_array_equal(CAMVID_MEAN, jax_camvid.CAMVID_MEAN)
    np.testing.assert_allclose(TrainConfig(data_set="camvid").input_mean_bgr, CAMVID_MEAN,
                               rtol=1e-7)
    labels = np.stack([ours[i][1] for i in range(len(ours))])
    assert labels.max() <= 10 or set(np.unique(labels[labels > 10]).tolist()) == {255}


@pytest.mark.parametrize("scale,mirror,crop", [(True, True, (48, 64)), (False, False, (64, 96))],
                         ids=["train", "val"])
def test_voc_dataset_matches_jax(voc, scale, mirror, crop):
    root, lists = voc
    kw = dict(crop_size=crop, scale=scale, mirror=mirror, seed=5)
    ours = VOCDataset(root, lists["train"], max_iters=4, **kw)
    ref = jax_voc.VOCDataset(root, lists["train"], max_iters=4, **kw)
    assert len(ours) == len(ref) == 6
    _same_items(ours, ref, len(ours))


def test_voc_test_dataset_matches_jax(voc):
    root, lists = voc
    ours = VOCTestDataset(root, lists["test"], crop_size=(64, 96))
    ref = jax_voc.VOCTestDataset(root, lists["test"], crop_size=(64, 96))
    assert len(ours) == len(ref) == 2
    _same_items(ours, ref, 2)
    assert ours[1][0].shape == (64, 96, 3) and tuple(ours[1][1][:2]) == (52, 68)


@pytest.mark.parametrize("name", ["camvid", "voc"])
def test_datasets_through_workers_and_cast(camvid, voc, name):
    """Two spawned workers give the serial batches (unaugmented: no draw
    moves the crop), and `cast_batches` narrows them to bf16 images and
    uint8 labels."""
    root, lists = camvid if name == "camvid" else voc
    if name == "camvid":
        ds = CamVidDataset(root, lists["train"], crop_size=(360, 480), scale=False, mirror=False)
    else:
        ds = VOCDataset(root, lists["val"], crop_size=(64, 96), scale=False, mirror=False)
    serial = list(batch_iterator(ds, 2, shuffle=True, seed=1, drop_last=False))
    pooled = list(batch_iterator(ds, 2, shuffle=True, seed=1, drop_last=False, num_workers=2))
    assert len(serial) == len(pooled)
    for a, b in zip(serial, pooled):
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[3] == b[3]
    cast = list(cast_batches(iter(serial), torch.bfloat16, torch.uint8))
    assert cast[0][0].dtype == torch.bfloat16 and cast[0][1].dtype == torch.uint8
    np.testing.assert_array_equal(cast[0][1].numpy(), serial[0][1])


# ---------------------------------------------------------------- remat
def _small_r18(remat, bn_fused=False):
    return ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0,
                     generator=torch.Generator().manual_seed(4), remat=remat, bn_fused=bn_fused)


@pytest.mark.parametrize("bn_fused", [False, True], ids=["unfused", "fused"])
def test_remat_student_equals_plain(bn_fused, monkeypatch):
    """Outputs, gradients and running statistics bit for bit; the statistics
    move once (not twice: the recompute leaves them alone), and the fused
    ABN's forward runs again in each block's recompute."""
    x = torch.randn(2, 3, 96, 96, generator=torch.Generator().manual_seed(0))
    x[1] = 2.0 * x[1] + 0.5
    weights = [torch.randn(s, generator=torch.Generator().manual_seed(1))
               for s in ((2, 7, 13, 13), (2, 7, 13, 13))]
    calls = {"n": 0}
    real = fused_bn.bn_act

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(fused_bn, "bn_act", counting)
    runs = {}
    for remat in (False, True):
        model = _small_r18(remat, bn_fused).train()
        start = {k: v.clone() for k, v in model.state_dict().items()}
        calls["n"] = 0
        outs = model(x)
        forward_calls = calls["n"]
        loss = sum((o * w).sum() for o, w in zip(outs[:2], weights))
        loss.backward()
        runs[remat] = dict(outs=[o.detach() for o in outs], calls=(forward_calls, calls["n"]),
                           grads={k: p.grad.clone() for k, p in model.named_parameters()},
                           state=model.state_dict(), start=start)
    plain, remat = runs[False], runs[True]
    for a, b in zip(plain["outs"], remat["outs"]):
        assert torch.equal(a, b)
    for k, g in plain["grads"].items():
        assert torch.equal(g, remat["grads"][k]), k
    stats = [k for k in plain["state"] if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert torch.equal(plain["state"][k], remat["state"][k]), k
        assert not torch.equal(remat["state"][k], remat["start"][k]), k
    if bn_fused:
        # the 4 BasicBlocks (each with a downsample ABN at these widths: 3
        # ABNs) run their forward once more; the stem, PSP and DSN do not
        block_abns = 4 * 3
        assert plain["calls"] == (plain["calls"][0], plain["calls"][0])
        assert remat["calls"][0] == plain["calls"][0]
        assert remat["calls"][1] - remat["calls"][0] == block_abns


def _train_state(t_model, s_model, d_model, cfg):
    t_model.requires_grad_(False)
    return KDTrainState(
        teacher=t_model, student=s_model, discriminator=d_model,
        g_opt=make_sgd(s_model.parameters(), cfg.lr_g, cfg.momentum, cfg.weight_decay),
        d_opt=make_sgd(d_model.parameters(), cfg.lr_d, cfg.momentum, cfg.weight_decay),
        g_sched=poly_schedule(cfg.lr_g, cfg.num_steps, cfg.power),
        d_sched=poly_schedule(cfg.lr_d, cfg.num_steps, cfg.power))


def _cfg(classes, **extra):
    return dict(classes_num=classes, batch_size=2, input_size=(256, 256), imsize_for_adv=33,
                adv_conv_dim=16, num_steps=4, pi=True, pa=True, ho=True, adv_loss_type="wgan-gp",
                lambda_pi=10.0, lambda_pa=0.7, lambda_d=0.13, lambda_gp=10.0, pool_scale=0.5,
                compute_dtype="float32", **extra)


def _batches(classes, n_steps, seed):
    rng = np.random.RandomState(seed)
    images = rng.randn(n_steps, 2, 256, 256, 3).astype(np.float32)
    images[:, 1] = 3.0 * images[:, 1] + 1.0
    labels = rng.randint(0, classes, (n_steps, 2, 256, 256)).astype(np.int32)
    labels[:, 0, :16] = 255
    return rng, images, labels


def _run_jax(student_jax, export, classes, n_steps, seed):
    """n_steps of the JAX step from randomised weights; returns (losses per
    step, student/D state dicts per step, the port's start: teacher state
    dict, batches and the GP α of each step)."""
    rng, images_k, labels_k = _batches(classes, n_steps, seed)
    jcfg = JaxTrainConfig(**_cfg(classes), fused_ce="true")
    teacher = JaxResPSPNet(block="bottleneck", layers=(1, 1, 1, 1), num_classes=classes,
                           drop_rate=0.0, width_mult=0.25)
    disc = JaxDiscriminator(preprocess_mode=1, image_size=33, conv_dim=16)
    key = jax.random.PRNGKey(0)
    x0 = jnp.asarray(images_k[0, :1])
    t_vars = _randomized_vars(rng, teacher.init(key, x0, train=False))
    s_vars = _randomized_vars(rng, student_jax.init(key, x0, train=False))
    d_vars = _randomized_vars(rng, disc.init(key, jnp.zeros((1, 33, 33, classes)), train=False))
    g_tx = jax_make_sgd(jcfg.lr_g, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    d_tx = jax_make_sgd(jcfg.lr_d, jcfg.num_steps, jcfg.power, jcfg.momentum, jcfg.weight_decay)
    state = create_train_state(jax.random.PRNGKey(7), t_vars, s_vars, d_vars, g_tx, d_tx)
    alphas = [torch.tensor(np.asarray(jax.random.uniform(
        jax.random.split(jax.random.fold_in(state.rng, i))[1], (2, 1, 1, 1), jnp.float32)))
        for i in range(n_steps)]
    step_fn = jax.jit(jax_make_train_step(jcfg, teacher, student_jax, disc, g_tx, d_tx))

    def dump(st):
        return (export({"params": st.student_params, "batch_stats": st.student_stats}),
                tckpt.discriminator_state_dict_from_jax({"params": st.d_params,
                                                         "batch_stats": st.d_stats,
                                                         "spectral": st.d_spectral}))

    sds, losses = [dump(state)], []
    for i in range(n_steps):
        state, metrics = step_fn(state, jnp.asarray(images_k[i]), jnp.asarray(labels_k[i]))
        losses.append({k: float(v) for k, v in metrics.items()})
        sds.append(dump(state))
    start = dict(teacher=tckpt.state_dict_from_jax(t_vars), student=sds[0][0], disc=sds[0][1],
                 images=images_k, labels=labels_k, alphas=alphas)
    return losses, sds, start


def _run_port(start, student_port, classes, **cfg_extra):
    """The port's steps from `_run_jax`'s start, with its α; returns (losses
    per step, student/D state dicts per step)."""
    cfg = TrainConfig(**_cfg(classes, **cfg_extra), device="cpu", fused_ce="true")
    t_model = ResPSPNet("bottleneck", (1, 1, 1, 1), classes, width_mult=0.25, drop_rate=0.0)
    d_model = Discriminator(classes, preprocess_mode=1, image_size=33, conv_dim=16)
    for model, sd in ((t_model, start["teacher"]), (student_port, start["student"]),
                      (d_model, start["disc"])):
        model.load_state_dict({k: torch.tensor(v) for k, v in sd.items()}, strict=True)
    pstate = _train_state(t_model, student_port, d_model, cfg)
    train_step = make_train_step(cfg)
    sds, losses = [(_numpy_sd(student_port), _numpy_sd(d_model))], []
    for images, labels, alpha in zip(start["images"], start["labels"], start["alphas"]):
        images = torch.from_numpy(images.transpose(0, 3, 1, 2).copy())
        metrics = train_step(pstate, images, torch.from_numpy(labels), alpha=alpha)
        losses.append({k: float(v) for k, v in metrics.items()})
        sds.append((_numpy_sd(student_port), _numpy_sd(d_model)))
    return losses, sds


def _check_steps(jax_losses, jax_sds, port_losses, port_sds, label):
    for i, jl in enumerate(jax_losses):
        assert sorted(port_losses[i]) == sorted(jl)
        for k, v in jl.items():
            np.testing.assert_allclose(port_losses[i][k], v, rtol=LOSS_RTOL[i],
                                       atol=LOSS_ATOL[i], err_msg=f"{label} step{i}:{k}")
    for i, name in enumerate(("student", "discriminator")):
        _compare_updates(jax_sds[1][i], port_sds[0][i], port_sds[1][i], 1, f"{label} {name}")
        _compare_state(jax_sds[1][i], port_sds[1][i], f"{label} {name}")


def test_remat_step_matches_jax_and_plain():
    """One remat step of the port (R18, layers (1,1,1,1), width 0.25) against
    the JAX remat step; and the port's remat and plain steps from one state
    agree bit for bit, running statistics included (updated once). The
    batches and weights come from seed 42, those of
    tests/test_torch_port_train_step.py, whose envelope was calibrated on
    them (from seed 21 the stem's bn1.bias update differs by 3.2 % between
    the packages, with and without remat alike)."""
    kw = dict(block="basic", layers=(1, 1, 1, 1), num_classes=7, drop_rate=0.0, width_mult=0.25)
    jax_losses, jax_sds, start = _run_jax(JaxResPSPNet(**kw, remat=True),
                                          tckpt.state_dict_from_jax, 7, 1, 42)
    port = {}
    for remat in (True, False):
        student = ResPSPNet("basic", (1, 1, 1, 1), 7, width_mult=0.25, drop_rate=0.0,
                            remat=remat)
        port[remat] = _run_port(start, student, 7, remat=remat)
    _check_steps(jax_losses, jax_sds, *port[True], "remat")
    assert port[False][0] == port[True][0]
    for a, b in zip(port[False][1][1], port[True][1][1]):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    before, after = port[True][1][0][0], port[True][1][1][0]
    assert [k for k in after if k.endswith(STATE_LEAVES[:2])
            and not np.array_equal(after[k], before[k])]


def test_espnet_cross_family_step_matches_jax():
    """Two steps with the ESPNet-C student under the small teacher: 33×33
    teacher logits and features resized to the student's 32×32 grid; the
    DSN CE through two one-head calls (heads 32×32 and 64×64 → 256²)."""
    jax_losses, jax_sds, start = _run_jax(JaxESPNetC(num_classes=ESP_CLASSES, p=1, q=2),
                                          tckpt.espnet_state_dict_from_jax, ESP_CLASSES, 2, 17)
    port_losses, port_sds = _run_port(start, ESPNetC(ESP_CLASSES, p=1, q=2), ESP_CLASSES,
                                      student_arch="espnet")
    _check_steps(jax_losses, jax_sds, port_losses, port_sds, "espnet")
    for i, name in enumerate(("student", "discriminator")):
        _compare_updates(jax_sds[2][i], port_sds[0][i], port_sds[2][i], 2, f"espnet {name}")


# ---------------------------------------------------------------- CLIs
def _scalars(log_dir):
    with open(os.path.join(log_dir, "scalars.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("name", ["camvid", "voc"])
def test_cli_train_camvid_espnet_and_voc(camvid, voc, tmp_path, name):
    """`cli.train` on the fake trees: CamVid with the ESPNet-C student (ho
    false, as scripts/run_camvid_espnet.sh) and the in-training eval at
    360×480 on the CamVid u8 wire; VOC with the R18 student at 21 classes
    and its eval at 505×505. Lists generated from the trees."""
    root, _ = camvid if name == "camvid" else voc
    lists = tmp_path / "lists"
    # 3 train frames, repeated to num_steps × batch = 6 samples: 3 steps
    common = ["--data-dir", root, "--batch-size", "2", "--num-steps", "3",
              "--teacher-layers", "1,1,1,1", "--device", "cpu", "--log-every", "1",
              "--random-scale", "--random-mirror", "--log-path", str(tmp_path / "log"),
              "--snapshot-dir", str(tmp_path / "snap"), "--S_ckpt_path", str(tmp_path / "ckpt")]
    if name == "camvid":
        argv = common + ["--data-set", "camvid", "--student-arch", "espnet", "--classes_num",
                         "11", "--input-size", "128,160", "--imsize-for-adv", "17", "--pi",
                         "true", "--pa", "true", "--ho", "false",
                         "--data-list", str(lists / "train.lst"),
                         "--val-data-list", str(lists / "val.lst")]
    else:
        argv = common + ["--data-set", "voc", "--classes_num", "21", "--input-size", "64,64",
                         "--imsize-for-adv", "9", "--ho", "false",
                         "--data-list", str(lists / "train_aug.txt"),
                         "--val-data-list", str(lists / "val.txt")]
    best = port_train_cli.main(argv)
    rows = _scalars(str(tmp_path / "log"))
    steps = [r for r in rows if "g_loss" in r]
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        assert all(math.isfinite(v) for v in r.values()), r
    assert [r["step"] for r in rows if "val_mean_iu" in r] == [2]
    assert 0.0 <= best <= 1.0
    snaps = list((tmp_path / "snap").glob("CS_scenes_2_*.pth"))
    assert len(snaps) == 1
    if name == "camvid":
        # the ESPNet snapshot carries the port's names and loads strictly
        ESPNetC(11).load_state_dict(torch.load(snaps[0], weights_only=True), strict=True)


def _meaniu(out):
    import re

    return float(re.search(r"meanIU: ([0-9.]+)", out).group(1))


def test_cli_eval_voc_matches_jax(voc, tmp_path, capsys):
    """The R18 student at 21 classes on the VOC val frames (padded to
    64×96, labels 255 there): the port's mIoU equals the JAX CLI's within
    1e-3 on the same `.pth`."""
    root, lists = voc
    variables = jax_student(21).init(jax.random.PRNGKey(2), jnp.zeros((1, 64, 96, 3)),
                                     train=False)
    pth = str(tmp_path / "student.pth")
    torch.save({k: torch.tensor(v) for k, v in jckpt.export_torch_respspnet(variables).items()},
               pth)
    args = ["--data-set", "voc", "--data-dir", root, "--data-list", lists["val"],
            "--eval-size", "64,96", "--resume-from", pth]
    jax_eval_cli.main(args)
    jax_out = capsys.readouterr().out
    port_eval_cli.main(args + ["--device", "cpu"])
    port_out = capsys.readouterr().out
    assert abs(_meaniu(port_out) - _meaniu(jax_out)) <= 1e-3


def test_cli_eval_camvid_espnet_matches_jax(tmp_path, capsys):
    """ESPNet-C (p=2, q=8) on CamVid val frames at 96×128: the JAX CLI reads
    the weights as a raw-variables `.msgpack`, the port as a `.pth` of its
    own names (`espnet_state_dict_from_jax`, loaded strictly)."""
    root = str(tmp_path / "camvid")
    write_fake_camvid(root, splits=(("val", 2),), size=(96, 128), seed=4)
    lst = make_camvid_lists(root, str(tmp_path / "list"))["val"]
    variables = JaxESPNetC(num_classes=11).init(jax.random.PRNGKey(3),
                                                jnp.zeros((1, 96, 128, 3)), train=False)
    with open(tmp_path / "espnet.msgpack", "wb") as f:
        f.write(serialization.msgpack_serialize(jax.tree.map(np.asarray, variables)))
    pth = str(tmp_path / "espnet.pth")
    torch.save({k: torch.tensor(v)
                for k, v in tckpt.espnet_state_dict_from_jax(variables).items()}, pth)
    args = ["--data-set", "camvid", "--student-arch", "espnet", "--data-dir", root,
            "--data-list", lst, "--eval-size", "96,128"]
    jax_eval_cli.main(args + ["--resume-from", str(tmp_path / "espnet.msgpack")])
    jax_out = capsys.readouterr().out
    port_eval_cli.main(args + ["--resume-from", pth, "--device", "cpu"])
    port_out = capsys.readouterr().out
    assert abs(_meaniu(port_out) - _meaniu(jax_out)) <= 1e-3


def test_cli_test_voc_writes_class_id_pngs(voc, tmp_path, monkeypatch):
    """`cli.test --data-set voc`: one PNG of class ids (no labelId remap) per
    test id; the CLI's 505×505 output size is cut to 64×96 here."""
    root, lists = voc
    monkeypatch.setattr(port_test_cli, "VOC_OUT_SIZE", (64, 96))
    out = tmp_path / "out"
    port_test_cli.main(["--data-set", "voc", "--data-dir", root, "--data-list", lists["test"],
                        "--classes_num", "21", "--output-dir", str(out), "--device", "cpu"])
    names = sorted(os.listdir(out))
    assert names == ["2007_test_000.png", "2007_test_001.png"]
    for name in names:
        with Image.open(out / name) as im:
            assert im.mode == "P"
            png = np.asarray(im)
        assert png.shape == (64, 96) and png.max() < 21


def test_camvid_u8_eval_wire_equals_f32(camvid):
    """The CamVid val frames (whole, unpadded: integer − the CamVid mean) on
    the u8 wire give the f32 wire's confusion exactly."""
    root, lists = camvid
    ds = CamVidDataset(root, lists["val"], crop_size=(360, 480), scale=False, mirror=False)
    frames = list(batch_iterator(ds, 1, shuffle=False, drop_last=False))
    model = ESPNetC(11, generator=torch.Generator().manual_seed(1)).eval()
    f32 = evaluate_main(model, frames, 11, out_size=(360, 480))
    u8 = evaluate_main(model, frames, 11, out_size=(360, 480), input_mean=CAMVID_MEAN)
    np.testing.assert_array_equal(u8[2], f32[2])
    assert int(f32[2].sum()) == sum(int((f[1] != 255).sum()) for f in frames)
