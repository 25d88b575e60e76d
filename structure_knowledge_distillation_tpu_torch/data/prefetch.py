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
    leaves the step's critical path. NHWC images become NCHW on the device.

The u8 image wire (`quantize_u8`) is ROADMAP Queue A item 4, and the
multi-step chunks (`Chunk`, `chunk_batches`) item 6c.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, NamedTuple, Optional

import numpy as np
import torch

__all__ = ["cast_batches", "device_prefetch"]


def _host_tensor(x) -> torch.Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))


def cast_batches(iterator: Iterator, image_dtype: Optional[torch.dtype] = None,
                 label_dtype: Optional[torch.dtype] = None) -> Iterator:
    """Cast the images and labels of (images, labels, ...) batches on the
    host; they come out as CPU tensors of the given dtypes (None keeps a
    field as it is). f32 → bf16 rounds to nearest even, as `ml_dtypes` does
    in the JAX package; the train step widens uint8 labels to int32 on the
    device."""
    for images, labels, *rest in iterator:
        if image_dtype is not None:
            images = _host_tensor(images).to(image_dtype)
        if label_dtype is not None:
            labels = _host_tensor(labels).to(label_dtype)
        yield (images, labels, *rest)


class _ProducerError(NamedTuple):
    """Carries a producer-thread exception to the consumer."""

    exc: BaseException


def _transfer(batch: tuple, device: torch.device, stream) -> tuple:
    """(images NHWC, labels, ...) on the host → (images NCHW, labels, ...) on
    `device`, and the event that marks the copies' end (None on the CPU).
    Every other field stays on the host."""
    images, labels, *rest = batch
    images, labels = _host_tensor(images), _host_tensor(labels)
    if stream is None:
        return (images.permute(0, 3, 1, 2).contiguous(), labels, *rest), None
    with torch.cuda.stream(stream):
        # the caching host allocator hands a pinned block out again only
        # after the copy that reads it has completed
        images = images.pin_memory().to(device, non_blocking=True)
        labels = labels.pin_memory().to(device, non_blocking=True)
        images = images.permute(0, 3, 1, 2).contiguous()
        event = torch.cuda.Event()
        event.record(stream)
    return (images, labels, *rest), event


def device_prefetch(iterator: Iterator, device, buffer_size: int = 2) -> Iterator:
    """Yield the batches of `iterator` with images (NCHW) and labels on
    `device`, staged by a producer thread `buffer_size` batches ahead.

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
