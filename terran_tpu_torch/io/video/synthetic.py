"""Synthetic video source with the ``Video`` iterator interface, a copy
of ``terran_tpu/io/video/synthetic.py``.

Stands in for an ffmpeg-decoded stream in benchmarks and tests: emits
deterministic uint8 NHWC batches at a chosen resolution without any
subprocess, for machines without an ffmpeg binary and for runs that
measure the device without a decoder in the way.
"""

import math

import numpy as np

from terran_tpu_torch.io.video import EndOfVideo


class SyntheticVideo:
    """Iterator of deterministic uint8 batches mimicking ``Video``."""

    def __init__(self, width=1920, height=1080, num_frames=300,
                 batch_size=None, framerate=30, seed=0, pattern="gradient"):
        self.width = width
        self.height = height
        self.num_frames = num_frames
        self.batch_size = batch_size
        self.framerate = framerate
        self.source_framerate = framerate
        self.duration = num_frames / framerate
        self._emitted = 0
        self._closed = False

        rng = np.random.default_rng(seed)
        if pattern == "noise":
            self._base = rng.integers(
                0, 255, (height, width, 3), dtype=np.uint8
            )
        else:
            yy, xx = np.mgrid[0:height, 0:width]
            self._base = np.stack(
                [
                    (xx * 255 // max(width - 1, 1)).astype(np.uint8),
                    (yy * 255 // max(height - 1, 1)).astype(np.uint8),
                    ((xx + yy) % 256).astype(np.uint8),
                ],
                axis=-1,
            )

    def _frame(self, idx):
        # Cheap per-frame variation: roll the base pattern.
        return np.roll(self._base, shift=idx % 16, axis=1)

    def read_frames(self):
        if self._closed or self._emitted >= self.num_frames:
            raise EndOfVideo
        if self.batch_size is None:
            frame = self._frame(self._emitted)
            self._emitted += 1
            return frame
        count = min(self.batch_size, self.num_frames - self._emitted)
        batch = np.stack(
            [self._frame(self._emitted + i) for i in range(count)]
        )
        self._emitted += count
        return batch

    def __iter__(self):
        return self

    def __next__(self):
        try:
            return self.read_frames()
        except EndOfVideo:
            raise StopIteration

    def __len__(self):
        batch_size = self.batch_size if self.batch_size else 1
        return math.ceil(self.num_frames / batch_size)

    def close(self):
        self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *args):
        self.close()
