"""Video I/O: the port of ``terran_tpu/io``'s video half (readers,
writer, synthetic source, device feeding). Image loading
(``open_image``, ``resolve_images``) waits with the PIL and requests leaf
group in ROADMAP.md, Queue 1 item 4."""

from terran_tpu_torch.io.video import (  # noqa
    EndOfVideo, ParallelVideo, SyntheticVideo, Video, VideoClosed,
    VideoWriter, device_prefetch, fixed_shape_batches, open_video,
    open_video_parallel, threaded_device_put, write_video,
)
