"""``models.load_model``, the one way from a model family's weights to a
model, over every family of ``models.FAMILIES`` and each precision it has,
on the CPU, with the weights of ``torch_oracle``'s random reference
checkpoints carried through the port's converters (the ViT at
``test_torch_vit``'s 2 blocks of width 64, BODY_25 at
``torch_body25_weights``' narrow widths).

The loaded state dict is held bit for bit to what the load is made of:
``cast_params_for_compute`` with the family's ``PARAMS_KEEP_F32`` names
(native), or the family's quantiser (int8). The task APIs and the
pipeline load through it, so given the same weights they hold the same
model.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch.face.detection import RetinaFaceDetector
from terran_tpu_torch.face.recognition import ArcFaceRecognizer
from terran_tpu_torch.models import FAMILIES, RECOGNIZERS, load_model
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.pose.openpose import OpenPoseEstimator
from terran_tpu_torch.runtime import PARAMS_KEEP_F32, cast_params_for_compute
from terran_tpu_torch.utils.convert import CONVERTERS, params_to_jax
from torch_body25_weights import body25_state_dict
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict, random_vit_state_dict,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401

REFERENCE = {"retinaface": random_retinaface_state_dict,
             "arcface": random_arcface_state_dict,
             "openpose": random_openpose_state_dict,
             "vit_l": random_vit_state_dict,
             "body25": body25_state_dict}
CASES = [(family, precision) for family, entry in FAMILIES.items()
         for precision in ("native", "int8")
         if precision == "native" or entry.int8 is not None]
NO_INT8 = [family for family, entry in FAMILIES.items() if entry.int8 is None]


@pytest.fixture(scope="module")
def params():
    """Each family's float32 state dict, converted from a random reference
    checkpoint."""
    rng = np.random.default_rng(41)
    return {family: CONVERTERS[family](REFERENCE[family](rng))
            for family in FAMILIES}


def expected_state(family, params, dtype, precision):
    if precision == "int8":
        _, quantize = FAMILIES[family].int8
        return quantize(params, dtype)
    return cast_params_for_compute(params, dtype,
                                   keep_f32=PARAMS_KEEP_F32[family])


def assert_same_state(got, want):
    assert got.keys() == want.keys()
    for name, value in want.items():
        assert got[name].dtype == value.dtype, name
        assert torch.equal(got[name], value), name


def test_the_table_covers_every_family():
    assert set(FAMILIES) == set(PARAMS_KEEP_F32) == set(REFERENCE)
    assert RECOGNIZERS == ("arcface", "vit_l")


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("family,precision", CASES)
def test_load_model_holds_the_cast_or_quantised_params(
        params, family, precision, dtype):
    model = load_model(family, params[family], dtype, "cpu", precision)
    assert not model.training
    assert isinstance(model, (FAMILIES[family].model if precision == "native"
                              else FAMILIES[family].int8[0]))
    assert_same_state(model.state_dict(), expected_state(
        family, params[family], dtype, precision))


@pytest.mark.parametrize("family", list(FAMILIES))
def test_kept_names_stay_float32(params, family):
    keep = PARAMS_KEEP_F32[family]
    state = load_model(family, params[family], torch.bfloat16,
                       "cpu").state_dict()
    kept = [name for name in state
            if any(name.startswith(k) or f".{k}" in name for k in keep)]
    assert bool(kept) == bool(keep)
    for name, value in state.items():
        if params[family][name].dtype == torch.float32:
            assert value.dtype == (torch.float32 if name in kept
                                   else torch.bfloat16), name


def test_a_jax_tree_loads_as_its_state_dict(params):
    tree = params_to_jax(params["openpose"], "openpose")
    assert_same_state(
        load_model("openpose", tree, torch.bfloat16, "cpu").state_dict(),
        load_model("openpose", params["openpose"], torch.bfloat16,
                   "cpu").state_dict())


@pytest.mark.parametrize("family", NO_INT8)
def test_a_family_without_an_int8_twin_raises(params, family):
    with pytest.raises(ValueError, match="no int8 trunk"):
        load_model(family, params[family], torch.bfloat16, "cpu", "int8")


@pytest.mark.parametrize("family,precision", [
    case for case in CASES if case[0] not in ("vit_l", "body25")])
def test_task_api_and_pipeline_hold_one_model(params, family, precision):
    """Given the same weights, a task API and the pipeline hold equal
    state dicts (the ViT and BODY_25 have no task API)."""
    kwargs = {"compute_dtype": torch.bfloat16, "device": "cpu"}
    if family == "retinaface":
        task = RetinaFaceDetector(params=params[family], **kwargs).model
        pipe = PerceptionPipeline(det_params=params[family], with_pose=False,
                                  with_embeddings=False, **kwargs).det_model
    elif family == "arcface":
        task = ArcFaceRecognizer(params=params[family],
                                 embed_precision=precision, **kwargs).model
        pipe = PerceptionPipeline(
            det_params=params["retinaface"], rec_params=params[family],
            with_pose=False, embed_precision=precision, **kwargs).rec_model
    else:
        task = OpenPoseEstimator(params=params[family],
                                 pose_precision=precision, **kwargs).model
        pipe = PerceptionPipeline(
            det_params=params["retinaface"], pose_params=params[family],
            with_embeddings=False, pose_precision=precision,
            **kwargs).pose_model
    assert type(task) is type(pipe)
    assert_same_state(task.state_dict(), pipe.state_dict())
