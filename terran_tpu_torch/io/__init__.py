"""Video and image I/O. Ported so far: the device feeding of
``terran_tpu/io/video/prefetch.py`` (``device_prefetch``,
``threaded_device_put``, ``fixed_shape_batches``); the readers, writers
and image loading wait in ROADMAP.md, Queue 1 item 11."""

from terran_tpu_torch.io.video import (  # noqa
    device_prefetch, fixed_shape_batches, threaded_device_put,
)
