"""Video I/O: ffmpeg-subprocess reader and writer with background
threads, a multi-process reader, a synthetic source and the device
feeding; the port of ``terran_tpu/io/video``.

Constants match the JAX package: a reader prefetch of 1 batch and a
64-frame writer buffer. The exceptions are defined before the submodules
import them; they are this package's own classes, so its readers raise
them and not the JAX package's.
"""

DEFAULT_READER_BUFFER_SIZE = 1
DEFAULT_WRITER_BUFFER_SIZE = 64


class EndOfVideo(Exception):
    pass


class VideoClosed(Exception):
    pass


from terran_tpu_torch.io.video.reader import Video, open_video  # noqa
from terran_tpu_torch.io.video.parallel import (  # noqa
    ParallelVideo, open_video_parallel,
)
from terran_tpu_torch.io.video.writer import VideoWriter, write_video  # noqa
from terran_tpu_torch.io.video.synthetic import SyntheticVideo  # noqa
from terran_tpu_torch.io.video.prefetch import (  # noqa
    device_prefetch, fixed_shape_batches, threaded_device_put,
)
