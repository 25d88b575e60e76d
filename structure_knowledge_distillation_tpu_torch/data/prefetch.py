"""Host batches to the device: the wire cast and a pinned-memory prefetcher.

Counterpart of `cast_batches` and `device_prefetch` in
`structure_knowledge_distillation_tpu/data/prefetch.py`. The reference hid
the host behind DataLoader workers and pinned memory (reference
train_and_eval.py:13-15); here a producer thread stages each batch on the
device while the current step runs:

  * `cast_batches` narrows the wire on the host: bf16 images (what the
    model's first op would make of f32 ones, round to nearest even, so the
    step sees the same bits at half the bytes) and uint8 labels;
  * `device_prefetch` copies each batch into pinned host memory and starts
    the host→device copies on a side CUDA stream, `buffer_size` batches
    ahead; the consumer's stream waits on the copy's event, so the copy
    leaves the step's critical path. NHWC images become NCHW on the device;
  * `chunk_batches` stacks `unroll` per-step batches into one `Chunk` on the
    host, for the multi-step loop (`training/train_step.py::
    make_train_loop`): both functions above carry a `Chunk` whole, so its
    `(unroll, N, ...)` stack crosses to the device in one pinned copy;
  * `quantize_u8` is the u8 image wire: mean-subtracted f32 images go back
    to their original bytes (a quarter of the f32 bytes); the train step and
    the eval programs subtract the mean again on the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["Chunk", "cast_batches", "chunk_batches", "device_prefetch", "quantize_u8",
           "to_nchw"]


def quantize_u8(images, mean) -> np.ndarray:
    """Re-quantize mean-subtracted f32 images (numpy, NHWC) to their
    original bytes, as the JAX `quantize_u8`: one f32 add of mean + 0.5 and
    a truncating cast, i.e. round half up. Integer−mean pixels (every
    unscaled, unpadded frame) come back exactly; pad pixels (0.0, "exactly
    the mean", which no byte holds) round by < 0.5. The one quantizer of the
    train wire (`cast_batches`) and the eval wire (`training/evaluate.py`).

    The same f32 add and cast per element as JAX's expression, over rows of
    W·C values against the mean tiled along a row, written straight into
    the uint8 result: broadcasting the C-vector over the last axis made
    numpy loop 3 values at a time, several times slower on a full frame."""
    images = np.asarray(images, np.float32)
    mean05 = np.asarray(mean, np.float32) + np.float32(0.5)
    rows = images.reshape(*images.shape[:-2], -1)
    out = np.empty(rows.shape, np.uint8)
    np.add(rows, np.tile(mean05, images.shape[-2]), out=out, casting="unsafe")
    return out.reshape(images.shape)


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


class Chunk(NamedTuple):
    """A stacked group of `unroll` training batches for the multi-step loop.

    `images`/`labels` carry a leading (unroll,) axis; the last
    `unroll - n_valid` entries are padding (repeats of the final batch) that
    the loop does not train on, so every chunk, the tail of a run whose step
    count is not a multiple of `unroll` included, has the same shapes."""

    images: object
    labels: object
    n_valid: int


def _stack(items: list):
    if isinstance(items[0], torch.Tensor):
        return torch.stack(items)
    return np.stack([np.asarray(x) for x in items])


def chunk_batches(iterator: Iterator, unroll: int) -> Iterator[Chunk]:
    """Stack per-step (images, labels, ...) batches into `Chunk`s of `unroll`
    on the host, before any device transfer, so that one copy moves a whole
    chunk; the tail chunk is padded with repeats of its last batch. numpy
    batches stack with numpy, tensors with `torch.stack`."""
    buf: list = []

    def emit(samples: list, n_valid: int) -> Chunk:
        samples = samples + [samples[-1]] * (unroll - len(samples))
        return Chunk(_stack([b[0] for b in samples]), _stack([b[1] for b in samples]),
                     n_valid)

    for b in iterator:
        buf.append(b)
        if len(buf) == unroll:
            yield emit(buf, unroll)
            buf = []
    if buf:
        yield emit(buf, len(buf))


def cast_batches(iterator: Iterator, image_dtype: Optional[torch.dtype] = None,
                 label_dtype: Optional[torch.dtype] = None, image_mean=None) -> Iterator:
    """Cast the images and labels of (images, labels, ...) batches, or of
    `Chunk`s, on the host; they come out as CPU tensors of the given dtypes
    (None keeps a field as it is). f32 → bf16 rounds to nearest even, as
    `ml_dtypes` does in the JAX package; the train step widens uint8 labels
    to int32 on the device. With `image_mean` set and `image_dtype` uint8,
    the images go through `quantize_u8` (the u8 wire), and the train step
    subtracts the mean again on the device."""
    for batch in iterator:
        images, labels = batch[0], batch[1]
        if image_mean is not None and image_dtype == torch.uint8:
            images = torch.from_numpy(quantize_u8(images, image_mean))
        elif image_dtype is not None:
            images = _host_tensor(images).to(image_dtype)
        if label_dtype is not None:
            labels = _host_tensor(labels).to(label_dtype)
        if isinstance(batch, Chunk):
            yield batch._replace(images=images, labels=labels)
        else:
            yield (images, labels, *batch[2:])


class _ProducerError(NamedTuple):
    """Carries a producer-thread exception to the consumer."""

    exc: BaseException


def to_nchw(images: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) images → (..., C, H, W), contiguous: a batch or a
    chunk's (unroll, N, H, W, C) stack."""
    d = images.dim()
    return images.permute(*range(d - 3), d - 1, d - 3, d - 2).contiguous()


def _transfer(batch: tuple, device: torch.device, stream) -> tuple:
    """(images NHWC, labels, ...) on the host → (images NCHW, labels, ...) on
    `device`, and the event that marks the copies' end (None on the CPU).
    Every other field stays on the host; a `Chunk` stays a `Chunk`."""
    images, labels = _host_tensor(batch[0]), _host_tensor(batch[1])
    if stream is not None:
        with torch.cuda.stream(stream):
            # the caching host allocator hands a pinned block out again only
            # after the copy that reads it has completed
            images = to_nchw(images.pin_memory().to(device, non_blocking=True))
            labels = labels.pin_memory().to(device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(stream)
    else:
        images, event = to_nchw(images), None
    if isinstance(batch, Chunk):
        return batch._replace(images=images, labels=labels), event
    return (images, labels, *batch[2:]), event


def device_prefetch(iterator: Iterator, device, buffer_size: int = 2) -> Iterator:
    """Yield the batches (or `Chunk`s) of `iterator` with images (NCHW) and
    labels on `device`, staged by a producer thread `buffer_size` batches
    ahead.

    On a CUDA device the producer copies through pinned memory on its own
    stream; before a batch is handed out, the current stream waits on its
    copy's event and `record_stream` keeps the caching allocator from
    recycling its memory under the step. `device="cpu"` (the tests) does the
    same work in the thread without streams. A CUDA device without CUDA
    raises.

    A producer exception is re-raised in the consumer (it would otherwise
    end a run as if the data had run out). When the consumer stops early
    (closes this generator), the producer stops at its next batch and closes
    `iterator`, so a worker pool upstream shuts down."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_prefetch to a CUDA device, but CUDA is not available")
    q: queue.Queue = queue.Queue(maxsize=buffer_size)
    stop = threading.Event()
    done = object()

    def put(item) -> bool:
        """Queue `item`; False once the consumer has stopped."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.05)
                return True
            except queue.Full:
                pass
        return False

    def producer() -> None:
        try:
            stream = torch.cuda.Stream(device) if device.type == "cuda" else None
            for batch in iterator:
                if not put(_transfer(batch, device, stream)):
                    break
        except BaseException as e:  # noqa: BLE001 — re-raised in the consumer
            put(_ProducerError(e))
        else:
            put(done)
        finally:
            close = getattr(iterator, "close", None)
            if close is not None:
                close()

    thread = threading.Thread(target=producer, name="device_prefetch", daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if item is done:
                return
            if isinstance(item, _ProducerError):
                raise item.exc
            batch, event = item
            if event is not None:
                current = torch.cuda.current_stream(device)
                current.wait_event(event)
                batch[0].record_stream(current)
                batch[1].record_stream(current)
            yield batch
    finally:
        stop.set()
        thread.join()
