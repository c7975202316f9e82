"""Host-to-device feeding of video batches.

The port of ``terran_tpu/io/video/prefetch.py``: ``fixed_shape_batches``
is copied; ``device_prefetch`` keeps ``depth`` batches uploaded ahead of
the consumer on a ``torch.device``; ``threaded_device_put`` moves the
uploads to a worker thread through a caller-given ``put``
(``PerceptionPipeline.process_stream`` passes its ``put_frames``, which
stages through pinned memory on its own CUDA stream).
"""

import queue
import threading
from collections import deque

import numpy as np
import torch

from terran_tpu_torch.runtime import resolve_device


def fixed_shape_batches(batch_iterator, batch_size=None):
    """Re-emit batches at a fixed leading size, padding the trailing batch.

    Yields ``(batch, valid_count)`` where the batch always has
    ``batch_size`` frames (trailing frames repeat the last valid frame) and
    ``valid_count`` says how many are real, so that every batch runs at
    one shape.

    ``batch_size`` defaults to the first batch's size.
    """
    for batch in batch_iterator:
        batch = np.asarray(batch)
        if batch.ndim == 3:
            batch = batch[None]
        if batch_size is None:
            batch_size = batch.shape[0]
        start = 0
        while start < batch.shape[0]:
            chunk = batch[start: start + batch_size]
            start += batch_size
            n = chunk.shape[0]
            if n < batch_size:
                chunk = np.concatenate(
                    [chunk, np.repeat(chunk[-1:], batch_size - n, axis=0)]
                )
            yield chunk, n


def _uploader(device):
    device = resolve_device(device)
    return lambda batch: torch.as_tensor(np.asarray(batch)).to(
        device, non_blocking=True)


def device_prefetch(batch_iterator, depth=None, device=None):
    """Yield device tensors from a host batch iterator, keeping ``depth``
    batches (default: config ``device_prefetch_depth``) uploaded ahead.

    ``device``: a ``torch.device`` or its name (default: the CUDA card;
    raises when there is none).
    """
    if depth is None:
        from terran_tpu_torch.config import get_config

        depth = get_config().device_prefetch_depth
    put = _uploader(device)

    buffer = deque()
    iterator = iter(batch_iterator)

    def enqueue():
        try:
            batch = next(iterator)
        except StopIteration:
            return False
        buffer.append(put(batch))
        return True

    for _ in range(depth):
        if not enqueue():
            break

    while buffer:
        batch = buffer.popleft()
        enqueue()
        yield batch


class _Feed:
    """The iterator ``threaded_device_put`` returns: its generator's items,
    and ``ready()``, which says without blocking whether the next item (a
    result or the end) is already queued."""

    def __init__(self, items, results):
        self._items = items
        self._results = results

    def __iter__(self):
        return self

    def __next__(self):
        return next(self._items)

    def ready(self):
        return not self._results.empty()

    def close(self):
        self._items.close()


def threaded_device_put(batch_iterator, depth=2, put=None):
    """Yield ``put(batch)`` for each batch, uploading from a background
    thread that keeps at most ``depth`` results ahead of the consumer, so
    that uploads overlap the consumer's dispatch, compute wait and result
    downloads.

    ``put`` defaults to a copy onto the CUDA card (raises when there is
    none). Exceptions from the source iterator or the upload propagate to
    the consumer at the point of ``next()``. The returned iterator's
    ``ready()`` is true once the next result, or the end, is queued: a
    consumer can ask whether ``next()`` would block. The thread starts at
    the first ``next()``.
    """
    if put is None:
        put = _uploader(None)

    results = queue.Queue(maxsize=max(1, depth))
    done = object()
    stop = threading.Event()
    failure = []

    def offer(item):
        """Bounded put that gives up if the consumer went away."""
        while not stop.is_set():
            try:
                results.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def uploader():
        try:
            for batch in batch_iterator:
                if not offer(put(batch)):
                    return
        except BaseException as error:  # propagated below
            failure.append(error)
        finally:
            offer(done)

    def items():
        worker = threading.Thread(
            target=uploader, name="terran-tpu-torch-uploader", daemon=True
        )
        worker.start()

        try:
            while True:
                item = results.get()
                if item is done:
                    worker.join()
                    if failure:
                        raise failure[0]
                    return
                yield item
        finally:
            stop.set()

    return _Feed(items(), results)
