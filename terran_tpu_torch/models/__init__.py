"""The port's model families (:data:`FAMILIES`) and the one way from a
family's weights to a model (:func:`load_model`). A new family adds its
model module, one entry here, its converter (``utils/convert.py``) and its
``runtime.PARAMS_KEEP_F32`` entry."""

from typing import NamedTuple

from terran_tpu_torch.models.retinaface import RetinaFace
from terran_tpu_torch.models.arcface import FaceResNet100
from terran_tpu_torch.models.openpose import BodyPoseModel
from terran_tpu_torch.models import arcface, body25, openpose, vit
from terran_tpu_torch.ops.pose_decode import BODY_25, COCO_18
from terran_tpu_torch.runtime import PARAMS_KEEP_F32, cast_params_for_compute
from terran_tpu_torch.utils.convert import as_state_dict


class Family(NamedTuple):
    """``model``: built by ``model.from_state_dict(state_dict, dtype)``.
    ``int8``: (twin, quantiser) or None, built as ``twin(dtype)`` with
    ``quantiser(state_dict, dtype)``. ``checkpoint``: the task class whose
    checkpoint the store holds, or None. ``recognizer``: embeds faces.
    ``skeleton``: a pose family's parts and limbs
    (``ops.pose_decode.Skeleton``), None for the others."""

    model: type
    int8: tuple = None
    checkpoint: str = None
    recognizer: bool = False
    skeleton: object = None


FAMILIES = {
    "retinaface": Family(
        RetinaFace,
        checkpoint="terran_tpu_torch.face.detection.RetinaFaceDetector"),
    "arcface": Family(
        FaceResNet100, (arcface.Int8FaceResNet100, arcface.quantize_params),
        "terran_tpu_torch.face.recognition.ArcFaceRecognizer", True),
    "openpose": Family(
        BodyPoseModel, (openpose.Int8BodyPoseModel, openpose.quantize_params),
        "terran_tpu_torch.pose.openpose.OpenPoseEstimator",
        skeleton=COCO_18),
    # The ViT of insightface's arcface_torch (weights: convert_vit_l).
    "vit_l": Family(vit.ViTRecognizer, recognizer=True),
    # OpenPose's BODY_25 (weights: convert_body25).
    "body25": Family(body25.Body25Model, skeleton=BODY_25),
}
RECOGNIZERS = tuple(name for name, f in FAMILIES.items() if f.recognizer)
POSE_FAMILIES = tuple(name for name, f in FAMILIES.items()
                      if f.skeleton is not None)


def load_model(family, params, dtype, device, precision="native"):
    """The ``family`` model with ``params`` (a state dict, or a
    ``terran_tpu`` pytree), on ``device``, in eval mode. Under 'int8' its
    twin, quantised from the float32 masters before the other leaves are
    cast to ``dtype``, as the JAX package quantises before its bf16 cast
    (``ValueError`` for a family with none); else in ``dtype`` but for its
    ``PARAMS_KEEP_F32`` names."""
    entry = FAMILIES[family]
    params = as_state_dict(params)
    if precision == "int8":
        if entry.int8 is None:
            raise ValueError(f"the {family!r} family has no int8 trunk")
        twin, quantize = entry.int8
        params = quantize(params, dtype)
        model = twin(dtype)
    else:
        params = cast_params_for_compute(
            params, dtype, keep_f32=PARAMS_KEEP_F32[family])
        model = entry.model.from_state_dict(params, dtype)
    model.load_state_dict(params, strict=True)
    return model.to(device).eval()
