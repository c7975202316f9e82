"""Face tracking (the port of ``terran_tpu/tracking``)."""

from terran_tpu_torch.tracking.face import (  # noqa
    FaceTracking, KalmanTracker, Sort, face_tracking,
)
