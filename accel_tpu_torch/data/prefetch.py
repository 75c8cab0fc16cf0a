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
        """``transform`` (optional) runs on each item in the producer thread."""
        self._it = iter(it)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._transform = transform
        self._done = object()
        self._err: BaseException | None = None
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            for item in self._it:
                if self._transform is not None:
                    item = self._transform(item)
                self._q.put(item)
        except BaseException as e:  # re-raised in the consumer by __next__
            self._err = e
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


def to_device(item: dict, device) -> dict:
    """A loader batch with its 'clip' and 'label' arrays as tensors on
    ``device``: on a CUDA device, copied from pinned host memory without
    blocking the host (on PyTorch's current stream, which the consumer
    shares); the rest of the batch as it is. A 1024x2048 f32 clip of 5
    frames is 126 MB."""
    device = torch.device(device)
    out = dict(item)
    for key in ("clip", "label"):
        t = torch.from_numpy(np.ascontiguousarray(item[key]))
        if device.type == "cuda":
            t = t.pin_memory().to(device, non_blocking=True)
        out[key] = t.to(device)
    return out
