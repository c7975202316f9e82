from terran_tpu_torch.models.retinaface import RetinaFace  # noqa
from terran_tpu_torch.models.arcface import FaceResNet100  # noqa
from terran_tpu_torch.models.openpose import BodyPoseModel  # noqa
