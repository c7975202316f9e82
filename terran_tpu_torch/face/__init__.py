"""Face tasks: detection and recognition (the port of
``terran_tpu/face``)."""

from terran_tpu_torch.face.detection import Detection, face_detection  # noqa
from terran_tpu_torch.face.recognition import (  # noqa
    Recognition, extract_features,
)
