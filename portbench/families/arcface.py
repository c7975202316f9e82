"""FaceResNet100, ArcFace's LResNet100E-IR (arXiv:1801.07698): the face
recognizer, one 112x112 aligned crop a face."""

from reference import models
from reference import pipeline as ref

ROLE = "recognizer"
EMBED_DIM = 512
specs = models.arcface_specs
forward = models.arcface_forward
embed = ref.embed


def input_size(height, width, cfg):
    return ref.CROP, ref.CROP


def pipeline_kwargs(sd):
    from terran_tpu_torch.utils.convert import convert_arcface

    return {"rec_params": convert_arcface(sd)}
