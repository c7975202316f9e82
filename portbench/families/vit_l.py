"""The ViT-L face recognizer of insightface's arcface_torch
(``backbones/vit.py``, ``vit_l_dp005_mask_005``; arXiv:2010.11929): one
112x112 aligned RGB crop a face, 144 tokens of 768 through 24 blocks. Its
attention core runs in float32, as the published code runs it."""

from reference import pipeline as ref
from reference import vit_l

ROLE = "recognizer"
EMBED_DIM = vit_l.EMBED_DIM
# The precision of the products of two activations (the attention core),
# whose least time harness/embed.py holds to that precision's peak rate.
ATTENTION = "float32"
specs = vit_l.vit_l_specs
forward = vit_l.vit_l_forward
embed = vit_l.embed


def input_size(height, width, cfg):
    return ref.CROP, ref.CROP


def pipeline_kwargs(sd):
    from terran_tpu_torch.utils.convert import convert_vit_l

    return {"rec_params": convert_vit_l(sd), "recognizer": "vit_l"}
