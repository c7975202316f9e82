"""The task APIs' precision keywords: ``ArcFaceRecognizer(embed_precision=)``
and ``OpenPoseEstimator(pose_precision=)``, as the JAX package's take them,
with their ``TERRAN_TPU_EMBED_PRECISION``/``TERRAN_TPU_POSE_PRECISION``
defaults. 'native' runs the float models; 'int8' runs the int8 ones on
weights quantised from the float32 masters; anything else raises
``ValueError``, as the pipeline does.
"""

import numpy as np
import pytest
import torch

from terran_tpu_torch.config import get_config, load_config, set_config
from terran_tpu_torch.face import Recognition
from terran_tpu_torch.face.recognition import ArcFaceRecognizer
from terran_tpu_torch.models.arcface import Int8FaceResNet100
from terran_tpu_torch.models.openpose import Int8BodyPoseModel
from terran_tpu_torch.pose import Estimation
from terran_tpu_torch.pose.openpose import OpenPoseEstimator
from terran_tpu_torch.utils.convert import convert_arcface, convert_openpose
from torch_oracle import random_arcface_state_dict, random_openpose_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

APIS = {
    "embed": (ArcFaceRecognizer, "embed_precision",
              "TERRAN_TPU_EMBED_PRECISION"),
    "pose": (OpenPoseEstimator, "pose_precision",
             "TERRAN_TPU_POSE_PRECISION"),
}
# A quantised conv of each model: int8 weights, float32 scales.
QUANTISED = {"embed": ("initial.conv", Int8FaceResNet100),
             "pose": ("conv1_1", Int8BodyPoseModel)}


def assert_int8(api, model):
    """``model`` (a task API's) runs the int8 trunk on quantised
    weights."""
    prefix, cls = QUANTISED[api]
    assert isinstance(model.model, cls)
    state = model.model.state_dict()
    assert state[f"{prefix}.weight_q"].dtype == torch.int8
    assert state[f"{prefix}.weight_scale"].dtype == torch.float32
    assert f"{prefix}.weight" not in state


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(0)
    return {"embed": convert_arcface(random_arcface_state_dict(rng)),
            "pose": convert_openpose(random_openpose_state_dict(rng))}


@pytest.fixture
def environment(monkeypatch):
    """Sets TERRAN_TPU_* variables and reloads the configuration from
    them; the saved configuration comes back after the test."""
    saved = get_config()

    def apply(**variables):
        for name, value in variables.items():
            monkeypatch.setenv(name, value)
        set_config(load_config())

    yield apply
    set_config(saved)


@pytest.mark.parametrize("api", sorted(APIS))
def test_native_keyword_runs(api, params):
    cls, keyword, _ = APIS[api]
    model = cls(params=params[api], device="cpu", **{keyword: "native"})
    assert getattr(model, keyword) == "native"


@pytest.mark.parametrize("api", sorted(APIS))
def test_int8_keyword_names_its_roadmap_item(api, params):
    """'int8' was ROADMAP Queue 1 item 5: it now runs and quantises."""
    cls, keyword, _ = APIS[api]
    model = cls(params=params[api], device="cpu", **{keyword: "int8"})
    assert getattr(model, keyword) == "int8"
    assert_int8(api, model)


@pytest.mark.parametrize("api", sorted(APIS))
def test_unknown_precision_raises(api):
    cls, keyword, _ = APIS[api]
    with pytest.raises(ValueError, match=keyword):
        cls(params={}, device="cpu", **{keyword: "fp8"})


@pytest.mark.parametrize("api", sorted(APIS))
def test_environment_sets_the_default(api, params, environment):
    cls, keyword, variable = APIS[api]
    environment(**{variable: "int8"})
    model = cls(params=params[api], device="cpu")
    assert getattr(model, keyword) == "int8"
    assert_int8(api, model)
    # The keyword overrides the environment.
    model = cls(params=params[api], device="cpu", **{keyword: "native"})
    assert getattr(model, keyword) == "native"
    environment(**{variable: "native"})
    assert getattr(cls(params=params[api], device="cpu"), keyword) == "native"
    environment(**{variable: "fp16"})
    with pytest.raises(ValueError, match=keyword):
        cls(params={}, device="cpu")


@pytest.mark.parametrize("task,api", [(Recognition, "embed"),
                                      (Estimation, "pose")])
def test_task_classes_pass_the_keyword(task, api, params):
    """The generic task classes hand model keywords to the wrapper."""
    _, keyword, _ = APIS[api]
    instance = task(device="cpu", params=params[api], **{keyword: "int8"})
    assert getattr(instance.model, keyword) == "int8"
    assert_int8(api, instance.model)
