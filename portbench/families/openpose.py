"""OpenPose, the CMU 2017 COCO body model (arXiv:1611.08050): 18 part
heatmaps, run at the pipeline's pose resize."""

from reference import models
from reference import pipeline as ref

ROLE = "pose"
PARTS = ref.PARTS
specs = models.openpose_specs
forward = models.openpose_forward
heatmaps = ref.heatmaps


def input_size(height, width, cfg):
    return ref.resized_shape(height, width, cfg["pose_short_side"])[:2]


def pipeline_kwargs(sd):
    from terran_tpu_torch.utils.convert import convert_openpose

    return {"pose_params": convert_openpose(sd)}
