"""The task APIs' precision keywords: ``ArcFaceRecognizer(embed_precision=)``
and ``OpenPoseEstimator(pose_precision=)``, as the JAX package's take them,
with their ``TERRAN_TPU_EMBED_PRECISION``/``TERRAN_TPU_POSE_PRECISION``
defaults. 'native' runs; 'int8' raises ``NotImplementedError`` naming its
ROADMAP item until the int8 trunks are ported; anything else raises
``ValueError``, as the pipeline does.
"""

import numpy as np
import pytest

from terran_tpu_torch.config import get_config, load_config, set_config
from terran_tpu_torch.face import Recognition
from terran_tpu_torch.face.recognition import ArcFaceRecognizer
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
def test_int8_keyword_names_its_roadmap_item(api):
    cls, keyword, _ = APIS[api]
    with pytest.raises(NotImplementedError, match="Queue 1 item 5"):
        cls(params={}, device="cpu", **{keyword: "int8"})


@pytest.mark.parametrize("api", sorted(APIS))
def test_unknown_precision_raises(api):
    cls, keyword, _ = APIS[api]
    with pytest.raises(ValueError, match=keyword):
        cls(params={}, device="cpu", **{keyword: "fp8"})


@pytest.mark.parametrize("api", sorted(APIS))
def test_environment_sets_the_default(api, params, environment):
    cls, keyword, variable = APIS[api]
    environment(**{variable: "int8"})
    with pytest.raises(NotImplementedError, match="item 5"):
        cls(params={}, device="cpu")
    # The keyword overrides the environment.
    model = cls(params=params[api], device="cpu", **{keyword: "native"})
    assert getattr(model, keyword) == "native"
    environment(**{variable: "native"})
    assert getattr(cls(params=params[api], device="cpu"), keyword) == "native"
    environment(**{variable: "fp16"})
    with pytest.raises(ValueError, match=keyword):
        cls(params={}, device="cpu")


@pytest.mark.parametrize("task,keyword", [(Recognition, "embed_precision"),
                                          (Estimation, "pose_precision")])
def test_task_classes_pass_the_keyword(task, keyword):
    """The generic task classes hand model keywords to the wrapper, which
    raises before it reads the checkpoint store."""
    with pytest.raises(NotImplementedError, match="item 5"):
        task(device="cpu", **{keyword: "int8"})
