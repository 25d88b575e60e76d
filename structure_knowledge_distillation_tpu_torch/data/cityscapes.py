"""Cityscapes train/val dataset and the host batcher (numpy).

Counterpart of `structure_knowledge_distillation_tpu/data/cityscapes.py`
(reference dataset/datasets.py:121-210):
  * `.lst` lines are "image_path<TAB>label_path" relative to the data root;
  * labels map labelId → trainId (34 → 19 + ignore 255);
  * train augmentation: random scale f ∈ {0.7, 0.8, …, 2.1} (cv2 INTER_LINEAR
    image, INTER_NEAREST label), BGR mean subtraction, zero/ignore padding up
    to the crop, random crop, random horizontal flip; val: mean subtraction,
    pad and crop only (the crop equals the frame, so its offsets are 0);
  * every draw comes from the dataset's seeded `np.random.Generator` in the
    JAX package's order, on the numpy path and on the native (C++) path
    alike, so both packages make the same crops for the same seed.

`CityscapesTestDataset` is the label-less test split (mean subtraction and
padding only). Samples stay HWC float32 / HW int32 numpy arrays, as in the
JAX package; the transpose to NCHW happens on the device. Images decode with
cv2 when it is installed, else PIL (and so does the numpy path's resize); a
decode cache (`data/cache.py`) can keep each decoded frame as an mmap'd .npy.
"""

from __future__ import annotations

import os.path as osp
from dataclasses import dataclass
from typing import Iterator, Optional, Tuple

import numpy as np

from structure_knowledge_distillation_tpu_torch.data.cache import cached_decode

__all__ = [
    "IMG_MEAN_BGR",
    "ID_TO_TRAINID_LUT",
    "id2trainid",
    "trainid2id",
    "CityscapesDataset",
    "CityscapesTestDataset",
    "batch_iterator",
]

# BGR mean, reference train_and_eval.py:10 / evaluate.py:21.
IMG_MEAN_BGR = np.array((104.00698793, 116.66876762, 122.67891434), dtype=np.float32)

_IGNORE = 255
# labelId -> trainId (reference datasets.py:146-151).
_ID_TO_TRAINID = {
    7: 0, 8: 1, 11: 2, 12: 3, 13: 4, 17: 5, 19: 6, 20: 7, 21: 8, 22: 9,
    23: 10, 24: 11, 25: 12, 26: 13, 27: 14, 28: 15, 31: 16, 32: 17, 33: 18,
}

ID_TO_TRAINID_LUT = np.full(256, _IGNORE, dtype=np.uint8)
for _k, _v in _ID_TO_TRAINID.items():
    ID_TO_TRAINID_LUT[_k] = _v

_TRAINID_TO_ID_LUT = np.zeros(256, dtype=np.uint8)
for _k, _v in _ID_TO_TRAINID.items():
    _TRAINID_TO_ID_LUT[_v] = _k


def id2trainid(label: np.ndarray) -> np.ndarray:
    """labelId (0..33) -> trainId (0..18 / 255), via LUT."""
    return ID_TO_TRAINID_LUT[label]


def trainid2id(label: np.ndarray) -> np.ndarray:
    """trainId -> labelId, for test-server submission PNGs."""
    return _TRAINID_TO_ID_LUT[label]


def _cv2():
    try:
        import cv2
    except ImportError:
        return None
    return cv2


def _imread(path: str, gray: bool) -> np.ndarray:
    """Decode to BGR uint8 (HWC) or gray uint8 (HW) with cv2, else PIL."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_GRAYSCALE if gray else cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    try:
        from PIL import Image
    except ImportError as e:
        raise RuntimeError("decoding images needs cv2 or PIL; neither is installed") from e
    with Image.open(path) as im:
        if gray:
            return np.asarray(im.convert("L"))
        return np.ascontiguousarray(np.asarray(im.convert("RGB"))[:, :, ::-1])


def _imread_color(path: str) -> np.ndarray:
    return _imread(path, gray=False)


def _imread_gray(path: str) -> np.ndarray:
    return _imread(path, gray=True)


def _resize(img: np.ndarray, fx: float, nearest: bool) -> np.ndarray:
    """cv2.resize by the factor fx on both axes; PIL only without cv2."""
    cv2 = _cv2()
    if cv2 is not None:
        interp = cv2.INTER_NEAREST if nearest else cv2.INTER_LINEAR
        return cv2.resize(img, None, fx=fx, fy=fx, interpolation=interp)
    from PIL import Image

    h, w = img.shape[:2]
    new = (int(round(w * fx)), int(round(h * fx)))
    mode = Image.NEAREST if nearest else Image.BILINEAR
    return np.asarray(Image.fromarray(img).resize(new, mode))


def augment(rng: np.random.Generator, image: np.ndarray, label: np.ndarray,
            crop: Tuple[int, int], mean: np.ndarray, scale_steps: Optional[int],
            scale_base: float, mirror: bool, ignore_label: int) -> tuple:
    """The JAX datasets' numpy train augmentation (Cityscapes, CamVid, VOC):
    a scale f = scale_base + integers(0, scale_steps)/10 (no draw when
    `scale_steps` is None; cv2 INTER_LINEAR image, INTER_NEAREST label),
    mean subtraction, zero/ignore padding up to `crop`, a random crop and,
    with `mirror`, a random flip; the draws in that order. Returns (image
    f32, label in its own dtype) cut to `crop`."""
    crop_h, crop_w = crop
    if scale_steps is not None:
        f = scale_base + int(rng.integers(0, scale_steps)) / 10.0
        image = _resize(image, f, nearest=False)
        # cv2 has no int32 nearest resize: the label resizes as uint8
        label = _resize(label.astype(np.uint8), f, nearest=True).astype(label.dtype)
    image = image.astype(np.float32) - mean
    pad_h = max(crop_h - label.shape[0], 0)
    pad_w = max(crop_w - label.shape[1], 0)
    if pad_h > 0 or pad_w > 0:
        image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
        label = np.pad(label, ((0, pad_h), (0, pad_w)), constant_values=ignore_label)
    h_off = int(rng.integers(0, label.shape[0] - crop_h + 1))
    w_off = int(rng.integers(0, label.shape[1] - crop_w + 1))
    image = image[h_off:h_off + crop_h, w_off:w_off + crop_w]
    label = label[h_off:h_off + crop_h, w_off:w_off + crop_w]
    if mirror and bool(rng.integers(0, 2)):
        image = image[:, ::-1]
        label = label[:, ::-1]
    return image, label


@dataclass
class _Record:
    img: str
    label: Optional[str]
    name: str


def _parse_lst(root: str, list_path: str, with_labels: bool) -> list:
    records = []
    with open(list_path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts:
                continue
            img_path = osp.join(root, parts[0])
            if with_labels:
                label_path = osp.join(root, parts[1])
                name = osp.splitext(osp.basename(parts[1]))[0]
            else:
                label_path = None
                name = osp.splitext(osp.basename(parts[0]))[0]
            records.append(_Record(img_path, label_path, name))
    return records


class CityscapesDataset:
    """Train/val dataset with the reference's augmentation.

    `max_iters` repeats the records up to at least that many samples (the
    reference sizes its train set to num_steps × batch_size). `use_native`
    takes the one-pass C++ augmentation (`data/native.py`, built on first
    use; a failed build raises); `use_native=False` takes the numpy/cv2
    path. The two agree in geometry and labels exactly and in pixel values
    within cv2's fixed-point rounding (≤ 1). `cache_dir` keeps decoded frames
    as .npy files (`data/cache.py`)."""

    def __init__(
        self,
        root: str,
        list_path: str,
        max_iters: Optional[int] = None,
        crop_size: Tuple[int, int] = (512, 512),
        mean: np.ndarray = IMG_MEAN_BGR,
        scale: bool = True,
        mirror: bool = True,
        ignore_label: int = 255,
        seed: int = 0,
        use_native: bool = True,
        cache_dir: Optional[str] = None,
    ):
        self.records = _parse_lst(root, list_path, with_labels=True)
        if max_iters is not None and self.records:
            reps = int(np.ceil(float(max_iters) / len(self.records)))
            self.records = self.records * reps
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)
        self.scale = scale
        self.mirror = mirror
        self.ignore_label = ignore_label
        self.cache_dir = cache_dir
        self.rng = np.random.default_rng(seed)
        if use_native:
            from structure_knowledge_distillation_tpu_torch.data.native import get_native_lib

            get_native_lib()
        self.use_native = use_native

    def __len__(self) -> int:
        return len(self.records)

    def _read(self, path: str, gray: bool) -> np.ndarray:
        return cached_decode(path, _imread_gray if gray else _imread_color, self.cache_dir)

    def __getitem__(self, index: int):
        rec = self.records[index]
        image = self._read(rec.img, gray=False)
        if self.use_native:
            return self._getitem_native(rec, image)
        label = id2trainid(self._read(rec.label, gray=True))
        size = np.array(image.shape)
        # f ∈ {0.7, 0.8, ..., 2.1} (reference datasets.py:157-161)
        image, label = augment(self.rng, image, label, (self.crop_h, self.crop_w), self.mean,
                               15 if self.scale else None, 0.7, self.mirror, self.ignore_label)
        return (
            np.ascontiguousarray(image, np.float32),
            np.ascontiguousarray(label, np.int32),
            size,
            rec.name,
        )

    def _getitem_native(self, rec, image: np.ndarray):
        """One-pass C++ augmentation; the numpy path's draws in its order,
        so both make the same geometry for a given seed."""
        from structure_knowledge_distillation_tpu_torch.data.native import native_augment

        raw_label = self._read(rec.label, gray=True)
        size = np.array(image.shape)
        f = 1.0
        if self.scale:
            f = 0.7 + int(self.rng.integers(0, 15)) / 10.0
        # cv2's destination size: round half to even (augment.cpp:41-46)
        new_h = int(round(image.shape[0] * f))
        new_w = int(round(image.shape[1] * f))
        img_h = max(new_h, self.crop_h)
        img_w = max(new_w, self.crop_w)
        h_off = int(self.rng.integers(0, img_h - self.crop_h + 1))
        w_off = int(self.rng.integers(0, img_w - self.crop_w + 1))
        flip = bool(self.rng.integers(0, 2)) if self.mirror else False
        out_img, out_label = native_augment(
            image, raw_label, f, (self.crop_h, self.crop_w), h_off, w_off,
            flip, self.mean, ID_TO_TRAINID_LUT, self.ignore_label,
        )
        return out_img, out_label, size, rec.name


class CityscapesTestDataset:
    """Full-resolution test frames without labels: mean subtraction and zero
    padding up to the crop only (reference datasets.py:212-250); items are
    (image HWC float32, size, name)."""

    def __init__(self, root: str, list_path: str, crop_size: Tuple[int, int] = (1024, 2048),
                 mean: np.ndarray = IMG_MEAN_BGR):
        self.records = _parse_lst(root, list_path, with_labels=False)
        self.crop_h, self.crop_w = crop_size
        self.mean = np.asarray(mean, np.float32)

    def __len__(self) -> int:
        return len(self.records)

    def __getitem__(self, index: int):
        rec = self.records[index]
        image = _imread_color(rec.img)
        size = np.array(image.shape)
        image = image.astype(np.float32) - self.mean
        pad_h = max(self.crop_h - image.shape[0], 0)
        pad_w = max(self.crop_w - image.shape[1], 0)
        if pad_h > 0 or pad_w > 0:
            image = np.pad(image, ((0, pad_h), (0, pad_w), (0, 0)), constant_values=0.0)
        return np.ascontiguousarray(image, np.float32), size, rec.name


_WORKER_DATASET = None


def _worker_init(dataset) -> None:
    global _WORKER_DATASET
    _WORKER_DATASET = dataset


def _worker_fetch(indices) -> list:
    return [_WORKER_DATASET[int(i)] for i in indices]


def _stack(samples) -> tuple:
    cols = list(zip(*samples))
    return tuple(
        np.stack(col) if isinstance(col[0], np.ndarray) else list(col)
        for col in cols
    )


class EvalShard:
    """One rank's frames of a val sweep sharded over `world` ranks, one frame
    a rank (as the JAX sweep puts one a device): rank r takes frame r of
    every group of `world`. Past the last frame the tail group's slots
    repeat the last frame with its size set to (0, 0), so they count nowhere
    and every rank runs the same number of frames. Only the rank's own
    frames (and that repeat) are decoded."""

    def __init__(self, dataset, rank: int, world: int):
        self.dataset, self.rank, self.world = dataset, rank, world

    def __len__(self) -> int:
        return -(-len(self.dataset) // self.world)

    def __getitem__(self, index: int):
        i = int(index) * self.world + self.rank
        if i < len(self.dataset):
            return self.dataset[i]
        image, label, size, name = self.dataset[len(self.dataset) - 1]
        return image, label, np.zeros_like(size), name


def batch_iterator(dataset, batch_size: int, shuffle: bool = True, seed: int = 0,
                   drop_last: bool = True, epochs: int = 1, num_workers: int = 0,
                   num_shards: int = 1, shard_index: int = 0) -> Iterator[tuple]:
    """Host batcher producing stacked NHWC numpy batches, in the JAX
    batcher's order: one seeded rng reshuffles the order at the start of
    every epoch.

    `num_workers > 0` decodes and augments in that many spawned processes
    (never forked: the trainer's process holds threads and a CUDA context),
    the dataset shipped once through the pool's initializer, with up to
    2 × num_workers batches in flight. Each worker holds its own copy of the
    dataset and its rng, so augmentation draws differ from the serial order,
    as with torch DataLoader workers and the JAX package's workers; the
    batch order does not. Workers never touch CUDA. Closing the generator
    (a consumer that stops early) cancels the batches not yet started and
    shuts the pool down.

    Data parallel (`num_shards` ranks, this one `shard_index`), as the JAX
    batcher: `batch_size` stays the global batch, every rank draws the same
    seeded order and takes its contiguous batch_size/num_shards slice of each
    global batch, so the ranks' batches partition each global batch exactly
    and a rank decodes only its own samples. The batch must divide, and a
    short tail batch cannot be split (drop_last)."""
    if batch_size % num_shards:
        raise ValueError(f"global batch {batch_size} not divisible by "
                         f"{num_shards} processes")
    if num_shards > 1 and not drop_last:
        raise ValueError("data-parallel sharding requires drop_last "
                         "(a short tail batch cannot be partitioned evenly)")
    local = batch_size // num_shards
    lo, hi = shard_index * local, (shard_index + 1) * local
    rng = np.random.default_rng(seed)
    n = len(dataset)
    end = n - (n % batch_size) if drop_last else n

    def index_batches():
        for _ in range(epochs):
            order = np.arange(n)
            if shuffle:
                rng.shuffle(order)
            for start in range(0, end, batch_size):
                yield order[start:start + batch_size][lo:hi]

    if num_workers <= 0:
        for idx in index_batches():
            yield _stack([dataset[int(i)] for i in idx])
        return

    import collections
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    with ProcessPoolExecutor(num_workers, initializer=_worker_init, initargs=(dataset,),
                             mp_context=multiprocessing.get_context("spawn")) as pool:
        pending: collections.deque = collections.deque()
        try:
            it = index_batches()
            for idx in it:
                pending.append(pool.submit(_worker_fetch, idx))
                if len(pending) == 2 * num_workers:
                    break
            while pending:
                samples = pending.popleft().result()
                idx = next(it, None)
                if idx is not None:
                    pending.append(pool.submit(_worker_fetch, idx))
                yield _stack(samples)
        finally:
            for fut in pending:
                fut.cancel()
