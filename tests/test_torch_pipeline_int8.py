"""The port's PerceptionPipeline with the opt-in int8 trunks
(``embed_precision='int8'``, ``pose_precision='int8'``) against the JAX
class with the same settings, float32 on the CPU.

The configuration is ``tests/test_torch_pipeline.py``'s: weights from
``default_rng(33)``, top_k 16, max_faces 4, max_peaks 8, no escalation,
at the shapes where both packages' resizes agree exactly: (2, 96, 128,
3) at det and pose short side 96 (the identity) under the device plan,
and (2, 128, 192, 3) at det 64 and pose 32 (x1/2 and x1/4, the pose
thresholds lowered so that random weights assemble humans) under the
'host' plan with its exact chain. Both quantise from the float32 masters
given to them.

Tolerances, as the native comparisons hold them: masks and overflows
equal, kept boxes and landmarks within one count and scores within
1e-5 (the RetinaFace forward is not quantised and sums in another
order), embeddings of valid slots within atol 2e-4 (the JAX package's
own tolerance between its two plans; measured: 1.7e-7, the int8 trunks
being bit-exact on equal crops), keypoints equal human for human.
"""

import numpy as np
import pytest
import torch

from terran_tpu.pipeline import PerceptionPipeline as JaxPipeline
from terran_tpu.utils.convert import convert_arcface as jax_convert_arcface
from terran_tpu.utils.convert import convert_openpose as jax_convert_openpose
from terran_tpu.utils.convert import (
    convert_retinaface as jax_convert_retinaface,
)
from terran_tpu_torch.config import get_config, load_config, set_config
from terran_tpu_torch.models.arcface import Int8FaceResNet100
from terran_tpu_torch.models.openpose import Int8BodyPoseModel
from terran_tpu_torch.pipeline import PerceptionPipeline
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import (  # noqa: F401
    single_torch_thread, single_torch_thread_module,
)

TINY = {"top_k": 16, "max_faces": 4, "max_peaks": 8, "max_escalations": 0}
INT8 = {"embed_precision": "int8", "pose_precision": "int8"}
LOWERED_POSE_THRESHOLDS = {"keypoint_threshold": -1e9,
                           "thresh_midpoint": -1e9, "human_threshold": -1e9}
HOST = {"transfer_plan": "host", "host_resize": "exact"}


@pytest.fixture(scope="module")
def jax_params():
    rng = np.random.default_rng(33)
    return (jax_convert_retinaface(random_retinaface_state_dict(rng)),
            jax_convert_arcface(random_arcface_state_dict(rng)),
            jax_convert_openpose(random_openpose_state_dict(rng)))


def frames_of(seed, shape):
    return np.random.default_rng(seed).integers(0, 255, shape, dtype=np.uint8)


def keypoints(poses):
    return [[person["keypoints"].tolist() for person in frame]
            for frame in poses]


@pytest.mark.parametrize("shape,det_side,pose_side,lowered,plan", [
    ((96, 128), 96, 96, False, {}),
    ((128, 192), 64, 32, True, HOST),
], ids=["device", "host"])
def test_int8_pipeline_matches_jax(jax_params, shape, det_side, pose_side,
                                   lowered, plan):
    config = dict(TINY, det_short_side=det_side, pose_short_side=pose_side,
                  **INT8, **plan)
    frames = frames_of(5, (2,) + shape + (3,))
    with JaxPipeline(*jax_params, **config) as jax_pipe, \
            PerceptionPipeline(*jax_params, device="cpu", **config) as port:
        for pipe in (jax_pipe, port):
            for name, value in (LOWERED_POSE_THRESHOLDS.items() if lowered
                                else ()):
                setattr(pipe, name, value)
        assert isinstance(port.rec_model, Int8FaceResNet100)
        assert isinstance(port.pose_model, Int8BodyPoseModel)
        exp = jax_pipe.process_batch(frames)
        got = port.process_batch(frames)

    assert got.keys() == exp.keys()
    for key in ("mask", "det_overflow", "pose_overflow", "embeddings_mask"):
        np.testing.assert_array_equal(got[key], exp[key], err_msg=key)
    mask = exp["mask"]
    assert mask.any(), "no faces to compare"
    for key in ("boxes", "landmarks"):
        assert got[key].dtype == np.int32 and got[key].shape == exp[key].shape
        assert np.abs(got[key][mask] - exp[key][mask]).max() <= 1, key
    np.testing.assert_allclose(got["scores"][mask], exp["scores"][mask],
                               rtol=0, atol=1e-5)
    valid = exp["embeddings_mask"]
    assert valid.any(), "no embeddings to compare"
    np.testing.assert_allclose(got["embeddings"][valid],
                               exp["embeddings"][valid], rtol=0, atol=2e-4)
    np.testing.assert_array_equal(got["embeddings"][~valid], 0.0)
    assert keypoints(got["poses"]) == keypoints(exp["poses"])
    if lowered:
        assert sum(map(len, exp["poses"])) > 0, "no humans to compare"


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


def test_int8_weights_stream_and_warmup(jax_params, environment):
    """The environment selects int8; the pipeline exposes the quantised
    weights (int8 convs, float32 scales, the other leaves in the compute
    dtype, the 'embed' head float32); warmup runs its programs; a stream
    equals its batches."""
    environment(TERRAN_TPU_EMBED_PRECISION="int8",
                TERRAN_TPU_POSE_PRECISION="int8")
    pipe = PerceptionPipeline(*jax_params, device="cpu",
                              compute_dtype=torch.bfloat16, **TINY,
                              det_short_side=64, pose_short_side=32)
    assert (pipe.embed_precision, pipe.pose_precision) == ("int8", "int8")
    rec, pose = pipe.rec_params, pipe.pose_params
    assert rec["initial.conv.weight_q"].dtype == torch.int8
    assert rec["initial.conv.weight_scale"].dtype == torch.float32
    assert rec["initial.scale"].dtype == torch.bfloat16
    assert rec["embed.weight"].dtype == torch.float32
    assert "initial.conv.weight" not in rec
    assert pose["Mconv7_stage6_L2.weight_q"].dtype == torch.int8
    assert pose["Mconv7_stage6_L2.bias"].dtype == torch.bfloat16
    assert sum(k.endswith(".weight_q") for k in rec) == 103
    assert sum(k.endswith(".weight_q") for k in pose) == 92
    assert pipe.warmup(2, 128, 192) > 0
    batches = [frames_of(8, (2, 128, 192, 3)), frames_of(9, (2, 128, 192, 3))]
    streamed = list(pipe.process_stream(batches, depth=2))
    for out, frames in zip(streamed, batches):
        exp = pipe.process_batch(frames)
        for key in ("boxes", "mask", "embeddings", "embeddings_mask"):
            np.testing.assert_array_equal(out[key], exp[key], err_msg=key)
        assert keypoints(out["poses"]) == keypoints(exp["poses"])
    pipe.close()
