"""OpenPose's BODY_25 (arXiv:1812.08008; ``models/pose/body_25/
pose_deploy.prototxt``): 25 part heatmaps with feet and a mid-hip, run at
the pipeline's pose resize."""

from reference import body25
from reference import pipeline as ref

ROLE = "pose"
PARTS = body25.PARTS
specs = body25.body25_specs
forward = body25.body25_forward
heatmaps = body25.heatmaps


def input_size(height, width, cfg):
    return ref.resized_shape(height, width, cfg["pose_short_side"])[:2]


def pipeline_kwargs(sd):
    from terran_tpu_torch.utils.convert import convert_body25

    return {"pose_params": convert_body25(sd), "pose": "body25"}
