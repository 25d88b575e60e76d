"""The port's train-data path against the JAX package's, on the CPU.

Each test feeds both packages the same fake Cityscapes tree (PNGs written
from a seed, `fake_cityscapes.py`) or the same numpy batches:
  * `CityscapesDataset` train items, native and numpy augmentation, with and
    without scale + mirror, at crops that force padding: exactly equal
    (images f32, labels int32, size, name), and so is `max_iters`;
  * `cached_decode`: the same cache file as the JAX package's; cached items
    equal uncached ones;
  * `batch_iterator`: the same order over two epochs; with spawned workers
    every record once per epoch and no process left behind;
  * `cast_batches`: bf16 bit patterns equal to `ml_dtypes`' round to
    nearest even, uint8 labels equal;
  * `device_prefetch` with `device="cpu"`: the same batches in order (images
    NCHW), a producer error re-raised, an early close that closes upstream;
  * `make_cityscapes_lists` / `ensure_list`: the same files.
A failed native build raises with the compiler's output.
"""

import multiprocessing
import os
import threading

import ml_dtypes
import numpy as np
import pytest
import torch
from fake_cityscapes import write_fake_cityscapes, write_list

from structure_knowledge_distillation_tpu.data import cache as jax_cache
from structure_knowledge_distillation_tpu.data import cast_batches as jax_cast_batches
from structure_knowledge_distillation_tpu.data import lists as jax_lists
from structure_knowledge_distillation_tpu.data.cityscapes import (
    CityscapesDataset as JaxCityscapes,
)
from structure_knowledge_distillation_tpu.data.cityscapes import (
    batch_iterator as jax_batch_iterator,
)
from structure_knowledge_distillation_tpu_torch.data import (
    CityscapesDataset,
    batch_iterator,
    cached_decode,
    cast_batches,
    device_prefetch,
    ensure_list,
    make_cityscapes_lists,
    native,
    warm_cache,
)
from structure_knowledge_distillation_tpu_torch.data.cache import _cache_path


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """Frames of three sizes, so a scale may make a frame smaller than the crop."""
    root = str(tmp_path_factory.mktemp("cityscapes"))
    pairs = []
    for k, size in enumerate(((40, 60), (23, 71), (66, 31))):
        sub = os.path.join(root, f"s{k}")
        got = write_fake_cityscapes(sub, splits=(("train", 2),), size=size, seed=k)
        pairs += [(os.path.join(f"s{k}", a), os.path.join(f"s{k}", b)) for a, b in got["train"]]
    return root, write_list(root, pairs)


def _assert_items_equal(ours, ref):
    img, lab, size, name = ours
    np.testing.assert_array_equal(img, ref[0])
    np.testing.assert_array_equal(lab, ref[1])
    np.testing.assert_array_equal(size, ref[2])
    assert name == ref[3]
    assert img.dtype == ref[0].dtype == np.float32
    assert lab.dtype == ref[1].dtype == np.int32


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
@pytest.mark.parametrize("augment", [True, False], ids=["scale+mirror", "plain"])
def test_cityscapes_train_items_equal_jax(tree, use_native, augment):
    root, lst = tree
    for seed in (0, 1, 2, 5):
        for crop in ((48, 64), (31, 17)):  # the first pads every frame in some dimension
            kw = dict(crop_size=crop, scale=augment, mirror=augment, seed=seed,
                      use_native=use_native)
            ref, ours = JaxCityscapes(root, lst, **kw), CityscapesDataset(root, lst, **kw)
            assert ref.use_native == ours.use_native == use_native
            for i in range(len(ours)):
                _assert_items_equal(ours[i], ref[i])


def test_max_iters_repeats_records_as_jax(tree):
    root, lst = tree
    for max_iters in (None, 5, 6, 7, 40):
        ref = JaxCityscapes(root, lst, max_iters=max_iters, use_native=False)
        ours = CityscapesDataset(root, lst, max_iters=max_iters, use_native=False)
        assert [(r.img, r.label, r.name) for r in ours.records] == \
            [(r.img, r.label, r.name) for r in ref.records]


def test_decode_cache_matches_jax_and_uncached(tree, tmp_path):
    root, lst = tree
    cache = str(tmp_path / "cache")
    ours = CityscapesDataset(root, lst, crop_size=(48, 64), seed=3, cache_dir=cache)
    path = ours.records[0].img
    assert _cache_path(cache, path) == jax_cache._cache_path(cache, path)
    assert warm_cache(ours) == len(ours)
    assert sorted(os.listdir(cache)) == sorted(
        os.path.basename(jax_cache._cache_path(cache, path))
        for r in ours.records for path in (r.img, r.label))
    cached = CityscapesDataset(root, lst, crop_size=(48, 64), seed=3, cache_dir=cache)
    uncached = CityscapesDataset(root, lst, crop_size=(48, 64), seed=3)
    for i in range(len(cached)):
        _assert_items_equal(cached[i], uncached[i])
    # a cached read is a memory map of the file the first read wrote
    arr = cached_decode(path, lambda p: pytest.fail("decoded again"), cache)
    assert isinstance(arr, np.memmap)


def test_batch_iterator_order_equals_jax(tree):
    root, lst = tree
    kw = dict(crop_size=(16, 16), scale=False, mirror=False, use_native=False)
    ours = CityscapesDataset(root, lst, max_iters=7, **kw)
    ref = JaxCityscapes(root, lst, max_iters=7, **kw)
    for bs, drop_last in ((2, True), (3, False)):
        a = list(batch_iterator(ours, bs, shuffle=True, seed=4, drop_last=drop_last, epochs=2))
        b = list(jax_batch_iterator(ref, bs, shuffle=True, seed=4, drop_last=drop_last,
                                    epochs=2))
        assert len(a) == len(b) > 0
        for x, y in zip(a, b):
            assert x[3] == y[3]
            for u, v in zip(x[:3], y[:3]):
                np.testing.assert_array_equal(u, v)


def test_batch_iterator_workers_cover_every_record_and_leave_nothing(tree):
    root, lst = tree
    ds = CityscapesDataset(root, lst, crop_size=(16, 16), seed=1)  # native, in the workers
    serial = [n for b in batch_iterator(ds, 2, seed=6, epochs=2) for n in b[3]]
    batches = list(batch_iterator(ds, 2, seed=6, epochs=2, num_workers=2))
    names = [n for b in batches for n in b[3]]
    assert names == serial  # the order; augmentation draws may differ
    per_epoch = len(ds)
    for e in range(2):
        assert sorted(names[e * per_epoch:(e + 1) * per_epoch]) == sorted(
            r.name for r in ds.records)
    assert batches[0][0].shape == (2, 16, 16, 3) and batches[0][1].dtype == np.int32
    assert multiprocessing.active_children() == []

    # a consumer that stops early: closing the generator shuts the pool down
    it = batch_iterator(ds, 2, seed=6, epochs=50, num_workers=2)
    next(it)
    it.close()
    assert multiprocessing.active_children() == []


def _float_cases(rng):
    """f32 values with every rounding case of f32 → bf16: random, exact ties
    (low 16 bits 0x8000, both parities), just above and below a tie,
    subnormals, zeros, infinities and the largest finite values."""
    bits = rng.integers(0, 2 ** 32, 4000, dtype=np.uint64).astype(np.uint32)
    bits[:1000] = (bits[:1000] & 0xFFFF0000) | 0x8000
    bits[1000:1500] = (bits[1000:1500] & 0xFFFF0000) | 0x8001
    bits[1500:2000] = (bits[1500:2000] & 0xFFFF0000) | 0x7FFF
    x = bits.view(np.float32)
    x = np.where(np.isnan(x), np.float32(1.5), x)
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-40, -1e-40, 3.4e38, -3.4e38,
                        np.finfo(np.float32).max], np.float32)
    return np.concatenate([x, special, rng.normal(0, 60, 4000).astype(np.float32)])


def test_cast_batches_bf16_bits_equal_ml_dtypes():
    rng = np.random.default_rng(0)
    values = _float_cases(rng)
    n = values.size // (5 * 7 * 3)
    images = values[:n * 5 * 7 * 3].reshape(n, 5, 7, 3)
    labels = rng.integers(0, 19, (n, 5, 7)).astype(np.int32)
    labels[:, 0] = 255
    batch = (images, labels, np.array([[5, 7, 3]] * n), ["n"] * n)
    (ref,) = list(jax_cast_batches(iter([batch]), ml_dtypes.bfloat16, "uint8"))
    (ours,) = list(cast_batches(iter([batch]), torch.bfloat16, torch.uint8))
    assert ours[0].dtype == torch.bfloat16 and ours[1].dtype == torch.uint8
    np.testing.assert_array_equal(ours[0].view(torch.int16).numpy(), ref[0].view(np.int16))
    np.testing.assert_array_equal(ours[1].numpy(), ref[1])
    assert ours[2] is batch[2] and ours[3] is batch[3]
    # None keeps a field as the dataset made it
    (same,) = list(cast_batches(iter([batch])))
    assert same[0] is images and same[1] is labels


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.normal(0, 60, (2, 6, 10, 3)).astype(np.float32),
             rng.integers(0, 19, (2, 6, 10)).astype(np.int32),
             np.array([[6, 10, 3]] * 2), [f"b{i}a", f"b{i}b"]) for i in range(n)]


def test_device_prefetch_cpu_yields_the_same_batches_in_order():
    batches = _batches(5)
    for buffer_size in (1, 2, 8):
        got = list(device_prefetch(iter(batches), "cpu", buffer_size=buffer_size))
        assert len(got) == len(batches)
        for (img, lab, size, names), ref in zip(got, batches):
            assert isinstance(img, torch.Tensor) and img.shape == (2, 3, 6, 10)
            assert img.is_contiguous()
            np.testing.assert_array_equal(img.numpy(), ref[0].transpose(0, 3, 1, 2))
            np.testing.assert_array_equal(lab.numpy(), ref[1])
            assert size is ref[2] and names is ref[3]
    # cast batches (CPU tensors) pass through the same way
    got = list(device_prefetch(cast_batches(iter(batches), torch.bfloat16, torch.uint8), "cpu"))
    assert got[0][0].dtype == torch.bfloat16 and got[0][1].dtype == torch.uint8


def test_device_prefetch_reraises_a_producer_error():
    def failing():
        yield from _batches(2)
        raise KeyError("decode failed")

    it = device_prefetch(failing(), "cpu")
    assert len([next(it), next(it)]) == 2
    with pytest.raises(KeyError, match="decode failed"):
        next(it)


def test_device_prefetch_early_close_closes_upstream():
    closed = threading.Event()

    def upstream():
        try:
            yield from _batches(50)
        finally:
            closed.set()

    before = {t.name for t in threading.enumerate()}
    it = device_prefetch(upstream(), "cpu", buffer_size=2)
    next(it)
    it.close()
    assert closed.is_set()
    assert not any(t.name == "device_prefetch" for t in threading.enumerate()
                   if t.name not in before)


def test_device_prefetch_needs_cuda_for_a_cuda_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")  # the card tests cover that case
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch(iter(_batches(1)), "cuda"))


def test_lists_equal_jax(tmp_path):
    root = str(tmp_path / "cs")
    write_fake_cityscapes(root, splits=(("train", 3), ("val", 2), ("test", 2)), size=(8, 8))
    ours = make_cityscapes_lists(root, str(tmp_path / "ours"))
    ref = jax_lists.make_cityscapes_lists(root, str(tmp_path / "ref"))
    assert sorted(ours) == sorted(ref) == ["test", "train", "val"]
    for split in ours:
        with open(ours[split]) as a, open(ref[split]) as b:
            assert a.read() == b.read()

    # ensure_list generates the reference-style default paths on first use
    for split in ("train", "val"):
        want = str(tmp_path / "dataset" / "list" / "cityscapes" / f"{split}.lst")
        ref_want = str(tmp_path / "ref_dataset" / f"{split}.lst")
        assert ensure_list("cityscapes", root, want) == want
        assert jax_lists.ensure_list("cityscapes", root, ref_want) == ref_want
        with open(want) as a, open(ref_want) as b:
            assert a.read() == b.read()
    assert ensure_list("cityscapes", "", "missing.lst") == "missing.lst"
    # VOC and CamVid lists are generated too (tests/test_torch_port_item7.py);
    # a root without their trees leaves the path for the loader to refuse, as in JAX
    for ds, name in (("voc", "train_aug.txt"), ("camvid", "train.lst")):
        want = str(tmp_path / ds / name)
        assert ensure_list(ds, root, want) == jax_lists.ensure_list(ds, root, want) == want


def test_native_build_failure_raises_with_compiler_output(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="failed to build .*\n.*g\\+\\+.*\n.*error"):
        native._build(tmp_path / "lib.so")
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="cannot be built"):
        native._build(tmp_path / "lib.so")
    assert sorted(p.name for p in tmp_path.iterdir()) == [".build.lock", "bad.cpp"]
