"""Image and video I/O: the port of ``terran_tpu/io`` (image loading,
readers, writer, synthetic source, device feeding). Image loading needs
Pillow, imported when ``open_image`` or ``resolve_images`` is called."""

from terran_tpu_torch.io.image import open_image, resolve_images  # noqa
from terran_tpu_torch.io.video import (  # noqa
    EndOfVideo, ParallelVideo, SyntheticVideo, Video, VideoClosed,
    VideoWriter, device_prefetch, fixed_shape_batches, open_video,
    open_video_parallel, threaded_device_put, write_video,
)
