"""RetinaFace with the mobilenet-0.25 backbone (arXiv:1905.00641): the
face detector, run at the pipeline's detection resize."""

from reference import models
from reference import pipeline as ref

ROLE = "detector"
specs = models.retinaface_specs
forward = models.retinaface_forward
detect = ref.detect
anchors = ref.anchors


def input_size(height, width, cfg):
    return ref.resized_shape(height, width, cfg["det_short_side"])[:2]


def pipeline_kwargs(sd):
    from terran_tpu_torch.utils.convert import convert_retinaface

    return {"det_params": convert_retinaface(sd)}
