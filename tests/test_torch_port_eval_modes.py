"""The port's inference modes and the u8 image wire vs the JAX package, on the CPU.

One small student on both sides (`ResPSPNet("basic", (1, 1, 1, 1), 7,
width_mult=0.25)`, JAX init with random running statistics, crossed over with
`state_dict_from_jax`) over 64×128 integer−mean frames made from a seed, some
with a valid size smaller than the frame so the in-bounds mask matters:
  * multiscale+flip (`make_msf_val_fn`), sliding tiles (`make_sliding_val_fn`,
    48² tiles for the edge shift and 80² for the padding) and the batched
    sweep (`evaluate_sharded`, batch 3 over 5 frames: one full group and a
    tail group with a masked slot, single-scale and msf) against the JAX
    functions: class maps ≥ 99.9 % equal, mIoU within 1e-3, the confusion's
    pixel count exact;
  * `quantize_u8` and the u8 branch of `cast_batches` equal to JAX's;
  * the u8 eval wire on `tests/fake_cityscapes.py` frames: every sweep's
    confusion equals its f32 confusion exactly;
  * the train step and `make_train_loop(unroll=2)` on u8 batches bit-equal to
    the same batches de-quantized on the host;
  * `CityscapesTestDataset`, the test sweep (whole, msf, sliding: labelId
    palette PNGs) and `TestConfig` against JAX's; `cli.test` end to end.

The JAX side runs its XLA resize + argmax; the port's CPU path is
`upsampled_argmax_plain` and matmul resizes. They differ only in float
association, hence 99.9 % and 1e-3 rather than equality.
"""

import copy
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from fake_cityscapes import write_fake_cityscapes, write_list
from test_torch_port_eval import _random_stats, _read_png
from test_torch_port_train_loop import _port_state
from test_torch_port_train_step import (  # noqa: F401 (_two_threads: an autouse fixture)
    _cfg_kwargs,
    _two_threads,
)

from structure_knowledge_distillation_tpu.config import TestConfig as JaxTestConfig
from structure_knowledge_distillation_tpu.data import CityscapesTestDataset as JaxTestDataset
from structure_knowledge_distillation_tpu.data import batch_iterator as jax_batches
from structure_knowledge_distillation_tpu.data.prefetch import cast_batches as jax_cast_batches
from structure_knowledge_distillation_tpu.data.prefetch import quantize_u8 as jax_quantize_u8
from structure_knowledge_distillation_tpu.models import ResPSPNet as JaxResPSPNet
from structure_knowledge_distillation_tpu.training import evaluate as jev
from structure_knowledge_distillation_tpu_torch.cli import eval as port_eval_cli
from structure_knowledge_distillation_tpu_torch.cli import test as port_test_cli
from structure_knowledge_distillation_tpu_torch.config import TestConfig, TrainConfig
from structure_knowledge_distillation_tpu_torch.data import (
    IMG_MEAN_BGR,
    CityscapesDataset,
    CityscapesTestDataset,
    Chunk,
    batch_iterator,
    cast_batches,
    quantize_u8,
    trainid2id,
)
from structure_knowledge_distillation_tpu_torch.models import ResPSPNet
from structure_knowledge_distillation_tpu_torch.training import checkpoint as tckpt
from structure_knowledge_distillation_tpu_torch.training import evaluate as pev
from structure_knowledge_distillation_tpu_torch.training.train_step import (
    make_train_loop,
    make_train_step,
)

SIZE = (64, 128)
CLASSES = 7
AGREEMENT_MIN = 0.999
MIOU_ATOL = 1e-3
MSF = ((0.75, 1.0, 1.25), True)
LABEL_IDS = set(int(v) for v in trainid2id(np.arange(CLASSES, dtype=np.uint8)))


@pytest.fixture(scope="module")
def models():
    """(JAX model, its variables, the port's model with the same weights)."""
    jmodel = JaxResPSPNet(block="basic", layers=(1, 1, 1, 1), num_classes=CLASSES,
                          width_mult=0.25)
    variables = jmodel.init(jax.random.PRNGKey(0), jnp.zeros((1, *SIZE, 3)), train=False)
    variables = _random_stats(variables, np.random.RandomState(0))
    model = ResPSPNet("basic", (1, 1, 1, 1), CLASSES, width_mult=0.25)
    model.load_state_dict({k: torch.tensor(v)
                           for k, v in tckpt.state_dict_from_jax(variables).items()}, strict=True)
    return jmodel, variables, model.eval()


def _frames(n, seed=0):
    """n batch-1 val items (image (1, H, W, 3) f32, label (1, H, W) int32,
    size (1, 3), [name]): integer bytes of a smooth field plus noise, minus
    the BGR mean; odd frames report a valid size smaller than the frame."""
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        field = rng.uniform(0, 255, (1, 5, 9, 3))
        raw = np.repeat(np.repeat(field, 16, axis=1), 16, axis=2)[:, : SIZE[0], : SIZE[1]]
        raw = np.clip(np.rint(raw + rng.normal(0, 20, raw.shape)), 0, 255).astype(np.float32)
        label = rng.integers(0, CLASSES, (1, *SIZE)).astype(np.int32)
        label[0, :3] = 255
        size = (SIZE[0] - 9, SIZE[1] - 21) if i % 2 else SIZE
        items.append((raw - IMG_MEAN_BGR, label, np.array([[*size, 3]]), [f"f{i}"]))
    return items


def _expected_pixels(items):
    return sum(int((lab[0, : s[0][0], : s[0][1]] != 255).sum()) for _, lab, s, _ in items)


def _port_frame(image, label):
    return (torch.from_numpy(image).permute(0, 3, 1, 2).contiguous(),
            torch.from_numpy(label[0].astype(np.uint8)))


def _compare_frame_fns(jrun, variables, run, items):
    """Both per-frame programs over `items`: class maps and summed confusions."""
    jconf = np.zeros((CLASSES, CLASSES))
    conf = np.zeros((CLASSES, CLASSES), np.int64)
    agree = []
    with torch.no_grad():
        for image, label, size, _ in items:
            h, w = int(size[0][0]), int(size[0][1])
            jp, jc = jrun(variables, jnp.asarray(image), jnp.asarray(label[0].astype(np.uint8)),
                          jnp.int32(h), jnp.int32(w))
            p, c = run(*_port_frame(image, label), h, w)
            assert p.shape == SIZE and p.dtype == torch.uint8
            agree.append((p.numpy() == np.asarray(jp)).mean())
            jconf += np.asarray(jc)
            conf += c.numpy()
    assert min(agree) >= AGREEMENT_MIN, agree
    assert int(conf.sum()) == int(jconf.sum()) == _expected_pixels(items)
    assert abs(pev.iu_from_confusion(conf)[0] - jev.iu_from_confusion(jconf)[0]) <= MIOU_ATOL


@pytest.mark.parametrize("scales,flip", [MSF, ((0.5, 1.0), False)], ids=["3scales-flip", "2scales"])
def test_msf_matches_jax(models, scales, flip):
    jmodel, variables, model = models
    jrun = jev.make_msf_val_fn(jmodel, SIZE, CLASSES, scales, flip)
    _compare_frame_fns(jrun, variables, pev.make_msf_val_fn(model, SIZE, CLASSES, scales, flip),
                       _frames(3, seed=1))


@pytest.mark.parametrize("tile", [(48, 48), (80, 80)], ids=["edge-shift", "padded"])
def test_sliding_matches_jax(models, tile):
    jmodel, variables, model = models
    jrun = jev.make_sliding_val_fn(jmodel, SIZE, tile, CLASSES)
    _compare_frame_fns(jrun, variables, pev.make_sliding_val_fn(model, SIZE, tile, CLASSES),
                       _frames(2, seed=2))


@pytest.mark.parametrize("scales,flip", [((1.0,), False), MSF], ids=["single-scale", "msf"])
def test_evaluate_sharded_matches_jax(models, scales, flip):
    """Batch 3 over 5 frames: a full group and a tail with one masked slot.
    The port's batched confusion equals its frame-at-a-time one exactly (the
    CPU path is batch-independent)."""
    jmodel, variables, model = models
    items = _frames(5, seed=3)
    jmiou, _ = jev.evaluate_sharded(jmodel, variables, items, CLASSES, out_size=SIZE, batch=3,
                                    scales=scales, flip=flip)
    miou, _, conf = pev.evaluate_sharded(model, items, CLASSES, out_size=SIZE, batch=3,
                                         scales=scales, flip=flip)
    _, _, conf_main = pev.evaluate_main(model, items, CLASSES, out_size=SIZE, scales=scales,
                                        flip=flip)
    assert conf.dtype == np.int64 and int(conf.sum()) == _expected_pixels(items)
    assert abs(miou - jmiou) <= MIOU_ATOL
    np.testing.assert_array_equal(conf, conf_main)


def test_predict_host_helpers_match_jax():
    """`predict_sliding` (edge shift and padding) and `predict_multiscale`
    (scipy zoom, flip, the mean over scales) on a deterministic predictor."""
    rng = np.random.default_rng(4)
    image = rng.normal(0, 50, (1, 40, 70, 3)).astype(np.float32)

    def tile_logits(tile):
        return np.concatenate([tile, tile[..., :1] * 2.0], axis=-1)

    for tile in ((32, 32), (48, 48)):
        np.testing.assert_array_equal(pev.predict_sliding(tile_logits, image, tile, 4),
                                      jev.predict_sliding(tile_logits, image, tile, 4))

    def whole_logits(img):
        out = np.zeros((1, 40, 70, 2))
        out[..., 0] = img[..., 0].mean() + np.arange(70)[None, None, :]
        out[..., 1] = img[..., 1].std()
        return out

    np.testing.assert_array_equal(pev.predict_multiscale(whole_logits, image, (0.5, 1.0), True),
                                  jev.predict_multiscale(whole_logits, image, (0.5, 1.0), True))


def test_quantize_u8_matches_jax():
    """Integer−mean pixels, arbitrary values and pad zeros; and the u8 branch
    of `cast_batches` on a batch and on a `Chunk`."""
    rng = np.random.default_rng(5)
    raw = rng.integers(0, 256, (2, 16, 24, 3)).astype(np.float32)
    images = raw - IMG_MEAN_BGR
    images[:, :, 20:] = 0.0  # pad pixels: "exactly the mean"
    noisy = rng.uniform(-130.0, 150.0, images.shape).astype(np.float32)
    for x in (images, noisy):
        ours, ref = quantize_u8(x, IMG_MEAN_BGR), jax_quantize_u8(x, IMG_MEAN_BGR)
        assert ours.dtype == np.uint8 and np.array_equal(ours, ref)
    assert np.array_equal(quantize_u8(images, IMG_MEAN_BGR)[:, :, :20], raw[:, :, :20])

    labels = rng.integers(0, CLASSES, (2, 16, 24)).astype(np.int32)
    [(ref_img, ref_lab)] = list(jax_cast_batches([(images, labels)], "uint8", "uint8",
                                                 image_mean=IMG_MEAN_BGR))
    [(img, lab)] = list(cast_batches([(images, labels)], torch.uint8, torch.uint8,
                                     image_mean=IMG_MEAN_BGR))
    [chunk] = list(cast_batches([Chunk(images[None], labels[None], 1)], torch.uint8,
                                torch.uint8, image_mean=IMG_MEAN_BGR))
    assert img.dtype == lab.dtype == torch.uint8
    assert np.array_equal(img.numpy(), ref_img) and np.array_equal(lab.numpy(), ref_lab)
    assert isinstance(chunk, Chunk) and np.array_equal(chunk.images.numpy()[0], ref_img)


@pytest.fixture(scope="module")
def fake_val(tmp_path_factory):
    """Three 64×128 val frames of `tests/fake_cityscapes.py` through the
    port's Cityscapes loader (native augmentation, no scale, no mirror)."""
    root = str(tmp_path_factory.mktemp("cityscapes_u8"))
    pairs = write_fake_cityscapes(root, splits=(("val", 3),), size=SIZE, seed=6)["val"]
    ds = CityscapesDataset(root, write_list(root, pairs, "val.lst"), crop_size=SIZE,
                           scale=False, mirror=False)
    # the small model has 7 classes: trainIds past them are ignored
    return [(image, np.where(label < CLASSES, label, 255), size, name)
            for image, label, size, name in batch_iterator(ds, 1, shuffle=False,
                                                           drop_last=False)]


@pytest.mark.parametrize("sweep", ["fast", "msf", "sliding", "sharded"])
def test_u8_eval_wire_equals_f32(models, fake_val, sweep):
    """The de-quantized frame is bit-identical to the f32 one, so the
    confusion is too."""
    model = models[2]

    def run(input_mean):
        if sweep == "sharded":
            return pev.evaluate_sharded(model, fake_val, CLASSES, out_size=SIZE, batch=2,
                                        input_mean=input_mean)[2]
        kw = {"fast": {}, "msf": dict(scales=MSF[0], flip=MSF[1]),
              "sliding": dict(whole=False, tile_size=(48, 48))}[sweep]
        return pev.evaluate_main(model, fake_val, CLASSES, out_size=SIZE, input_mean=input_mean,
                                 **kw)[2]

    f32 = run(None)
    assert int(f32.sum()) == sum(int((b[1] != 255).sum()) for b in fake_val) > 0
    np.testing.assert_array_equal(run(IMG_MEAN_BGR), f32)


def _u8_chunk(seed=7, k=2):
    """(k, 2, 3, 256, 256) uint8 images whose two frames differ in contrast,
    and the (k, 2, 256, 256) int32 labels, with an ignored band."""
    rng = np.random.default_rng(seed)
    raw = rng.integers(0, 256, (k, 2, 3, 256, 256)).astype(np.uint8)
    raw[:, 1] = raw[:, 1] // 3 + 80
    labels = rng.integers(0, CLASSES, (k, 2, 256, 256)).astype(np.int32)
    labels[:, 0, :16] = 255
    return torch.from_numpy(raw), torch.from_numpy(labels)


def _host_dequantized(images_u8, cfg):
    return images_u8.float() - torch.tensor(cfg.input_mean_bgr,
                                            dtype=torch.float32).view(3, 1, 1)


@pytest.mark.parametrize("through", ["step", "loop"])
def test_u8_train_wire_equals_host_dequantized(through):
    """Dropout on, one generator seed: the train step (eager) and the
    multi-step loop (unroll 2) on uint8 images give every metric and every
    state tensor bit for bit as on the same images de-quantized on the host."""
    cfg = TrainConfig(**_cfg_kwargs("wgan-gp"), device="cpu")
    u8_state = _port_state(cfg, None, drop_rate=0.1, seed=5)
    f32_state = copy.deepcopy(u8_state)
    images_u8, labels = _u8_chunk()
    images_f32 = _host_dequantized(images_u8, cfg)
    g_u8, g_f32 = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    if through == "step":
        step = make_train_step(cfg)
        m_u8 = step(u8_state, images_u8[0], labels[0], g_u8)
        m_f32 = step(f32_state, images_f32[0], labels[0], g_f32)
    else:
        m_u8 = make_train_loop(cfg, 2)(u8_state, images_u8, labels, 2, g_u8)
        m_f32 = make_train_loop(cfg, 2)(f32_state, images_f32, labels, 2, g_f32)
    assert sorted(m_u8) == sorted(m_f32)
    for k in m_u8:
        assert torch.equal(m_u8[k], m_f32[k]), k
    for attr in ("student", "discriminator"):
        a, b = getattr(u8_state, attr).state_dict(), getattr(f32_state, attr).state_dict()
        for k in a:
            assert torch.equal(a[k], b[k]), f"{attr}.{k}"


@pytest.fixture(scope="module")
def fake_test(tmp_path_factory):
    """A test split of two frames of random bytes, one 64×128 and one 48×100
    (padded up to the crop); returns (root, list path)."""
    import cv2

    root = str(tmp_path_factory.mktemp("cityscapes_test"))
    rng = np.random.default_rng(10)
    lines = []
    for i, (h, w) in enumerate((SIZE, (48, 100))):
        rel = f"leftImg8bit/test/city{i}/city{i}_{i:06d}_000019_leftImg8bit.png"
        os.makedirs(os.path.dirname(os.path.join(root, rel)), exist_ok=True)
        assert cv2.imwrite(os.path.join(root, rel),
                           rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        lines.append(f"{rel}\n")
    lst = os.path.join(root, "test.lst")
    with open(lst, "w") as f:
        f.writelines(lines)
    return root, lst


def test_cityscapes_test_dataset_matches_jax(fake_test):
    root, lst = fake_test
    ours, ref = CityscapesTestDataset(root, lst, crop_size=SIZE), JaxTestDataset(root, lst,
                                                                                 crop_size=SIZE)
    assert len(ours) == len(ref) == 2
    for i in range(2):
        (img, size, name), (jimg, jsize, jname) = ours[i], ref[i]
        assert img.dtype == np.float32 and img.shape == (*SIZE, 3)
        np.testing.assert_array_equal(img, jimg)
        np.testing.assert_array_equal(size, jsize)
        assert name == jname
    assert (ours[1][0][48:] == 0.0).all() and (ours[1][0][:, 100:] == 0.0).all()


@pytest.mark.parametrize("mode", ["whole", "msf", "sliding"])
def test_test_sweep_matches_jax(models, fake_test, tmp_path, mode):
    """labelId palette PNGs of both packages' test sweeps; the confusion is
    thrown away, so the sweep returns no scores."""
    jmodel, variables, model = models
    root, lst = fake_test
    kw = {"whole": {}, "msf": dict(scales=MSF[0], flip=MSF[1]),
          "sliding": dict(whole=False, tile_size=(48, 48))}[mode]
    jev.evaluate_main(jmodel, variables,
                      jax_batches(JaxTestDataset(root, lst, crop_size=SIZE), 1, shuffle=False,
                                  drop_last=False),
                      CLASSES, out_size=SIZE, eval_type="test", output_dir=str(tmp_path / "jax"),
                      **kw)
    out = pev.evaluate_main(model, batch_iterator(CityscapesTestDataset(root, lst, crop_size=SIZE),
                                                  1, shuffle=False, drop_last=False),
                            CLASSES, out_size=SIZE, eval_type="test",
                            output_dir=str(tmp_path / "port"), **kw)
    assert out == (None, None, None)
    from PIL import Image

    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 2
    for name in names:
        with Image.open(tmp_path / "port" / name) as a, Image.open(tmp_path / "jax" / name) as b:
            assert a.mode == b.mode == "P" and a.getpalette() == b.getpalette()
        ours, ref = _read_png(tmp_path / "port" / name), _read_png(tmp_path / "jax" / name)
        assert ours.shape == ref.shape == SIZE
        assert (ours == ref).mean() >= AGREEMENT_MIN
        assert set(np.unique(ours).tolist()) <= LABEL_IDS


def test_cli_test_writes_label_id_pngs(fake_test, tmp_path, monkeypatch):
    """`cli.test` end to end on the CPU with the full-width student: the test
    list, `CityscapesTestDataset`, the test sweep, one labelId PNG a frame.
    The CLI's 1024×2048 output size is cut to the frames' 64×128 here; the
    card runs it at full size (chip_smoke phase 17)."""
    root, lst = fake_test
    monkeypatch.setattr(port_test_cli, "OUT_SIZE", SIZE)
    out_dir = tmp_path / "submission"
    port_test_cli.main(["--data-dir", root, "--data-list", lst, "--output-dir", str(out_dir),
                        "--device", "cpu"])
    names = sorted(os.listdir(out_dir))
    assert names == ["city0_000000_000019_leftImg8bit.png", "city1_000001_000019_leftImg8bit.png"]
    for name in names:
        png = _read_png(out_dir / name)
        assert png.shape == SIZE
        assert set(np.unique(png).tolist()) <= set(trainid2id(np.arange(19, dtype=np.uint8)))


@pytest.mark.parametrize("argv", [
    [],
    ["--data-dir", "d", "--data-list", "l.lst", "--resume-from", "s.pth", "--classes_num", "11",
     "--output-dir", "o", "--whole", "false", "--flip", "true", "--scales", "0.75,1.0,1.25"],
], ids=["defaults", "all-flags"])
def test_test_config_matches_jax(argv):
    ours = dataclasses.asdict(TestConfig.from_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == dataclasses.asdict(JaxTestConfig.from_args(argv))
    assert TestConfig.from_args(argv + ["--device", "cpu"]).device == "cpu"


def test_test_config_accepts_voc():
    """The VOC test sweep is ported: its flags parse as the JAX TestConfig's."""
    argv = ["--data-set", "voc", "--classes_num", "21"]
    ours = dataclasses.asdict(TestConfig.from_args(argv))
    assert ours.pop("device") == "cuda"
    assert ours == dataclasses.asdict(JaxTestConfig.from_args(argv))
    assert TestConfig(data_set="voc").data_set == "voc"


@pytest.mark.parametrize("flags", [["--scales", "0.75,1.0,1.25", "--flip", "true"],
                                   ["--whole", "false", "--tile-size", "48,48"]],
                         ids=["msf", "sliding"])
def test_cli_eval_runs_the_other_sweeps(tmp_path, capsys, flags):
    """`cli.eval` with the msf and sliding flags prints the meanIU that the
    same sweep of `evaluate_main` gives on the same (seeded, full-width)
    student and frames."""
    root = str(tmp_path / "cityscapes")
    pairs = write_fake_cityscapes(root, splits=(("val", 2),), size=SIZE, seed=8)["val"]
    lst = write_list(root, pairs, "val.lst")
    miou = port_eval_cli.main(["--data-dir", root, "--data-list", lst, "--eval-size", "64,128",
                               "--device", "cpu"] + flags)
    assert f"meanIU: {miou:.6f}" in capsys.readouterr().out
    kw = dict(zip(flags[::2], flags[1::2]))
    ds = CityscapesDataset(root, lst, crop_size=SIZE, scale=False, mirror=False)
    want = pev.evaluate_main(
        port_eval_cli.load_student(19, torch.device("cpu"), ""),
        batch_iterator(ds, 1, shuffle=False, drop_last=False), 19, out_size=SIZE,
        whole=kw.get("--whole", "true") == "true",
        tile_size=tuple(map(int, kw.get("--tile-size", "512,512").split(","))),
        scales=tuple(map(float, kw.get("--scales", "1.0").split(","))),
        flip=kw.get("--flip", "false") == "true")[0]
    assert 0.0 <= miou <= 1.0 and miou == want
