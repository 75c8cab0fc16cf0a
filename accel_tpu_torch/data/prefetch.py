"""Background-thread prefetching (counterpart of ``accel_tpu/data/prefetch.py``).

A producer thread runs the loader (PNG decode, resize, normalize) while
the card runs the previous batch; :func:`to_device` is the ``transform``
that moves a batch to the card from pinned host memory with a
non-blocking copy, so the copy overlaps too.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch


class PrefetchingIter:
    def __init__(self, it, depth: int = 2, transform=None):
        """``transform`` (optional) runs on each item in the producer thread.
        ``close`` stops the producer of an endless iterator (the train
        loaders)."""
        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._err: BaseException | None = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                if not self._put(item):
                    return
        except BaseException as e:  # re-raised in the consumer by __next__
            self._err = e
        finally:
            self._put(self._done)

    def close(self, timeout: float = 60.0) -> None:
        """Stop the producer, drop what it queued and join it."""
        self._stop.set()
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device(item: dict, device, keys=("clip", "label")) -> dict:
    """A loader batch with its ``keys`` entries (arrays or tensors) as
    tensors on ``device``: on a CUDA device, copied from pinned host memory
    without blocking the host (on PyTorch's current stream, which the
    consumer shares); the rest of the batch as it is. A 1024x2048 f32 clip
    of 5 frames is 126 MB."""
    device = torch.device(device)
    out = dict(item)
    for key in keys:
        t = item[key]
        if not isinstance(t, torch.Tensor):
            t = torch.from_numpy(np.ascontiguousarray(t))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t.to(device)
    return out
