"""Video I/O. Ported so far: the device feeding of
``terran_tpu/io/video/prefetch.py``; the ffmpeg reader and writer wait in
ROADMAP.md, Queue 1 item 11."""

from terran_tpu_torch.io.video.prefetch import (  # noqa
    device_prefetch, fixed_shape_batches, threaded_device_put,
)
