"""Port's pose task API (OpenPoseEstimator, Estimation) vs the JAX package.

Images already have the short side the estimators resize to, so both
resizes are the identity and the two paths see the same pixels. Decode
outputs and final keypoints compare exactly; scores to rtol 1e-4.
"""

import numpy as np
import pytest
import torch

from terran_tpu.pose.openpose import OpenPoseEstimator as JaxEstimator
from terran_tpu.utils.convert import convert_openpose as jax_convert
from terran_tpu.utils.convert import save_params
from terran_tpu_torch.checkpoint import load_checkpoint_params
from terran_tpu_torch.ops.resize import resize_bilinear_u8, resized_shape
from terran_tpu_torch.pose import Estimation, Keypoint
from terran_tpu_torch.pose.openpose import OpenPoseEstimator
from terran_tpu_torch.utils.batching import merge_factory
from terran_tpu_torch.utils.convert import convert_openpose
from torch_oracle import random_openpose_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401

SHORT_SIDE = 96


@pytest.fixture(scope="module")
def state_dict():
    return random_openpose_state_dict(np.random.default_rng(21))


@pytest.fixture(scope="module")
def images():
    rng = np.random.default_rng(5)
    return rng.integers(0, 255, (2, SHORT_SIDE, 128, 3), dtype=np.uint8)


@pytest.fixture(scope="module")
def jax_estimator(state_dict):
    return JaxEstimator(params=jax_convert(state_dict),
                        short_side=SHORT_SIDE, max_peaks=16)


@pytest.fixture(scope="module")
def estimator(state_dict):
    return OpenPoseEstimator(params=convert_openpose(state_dict),
                             device="cpu", short_side=SHORT_SIDE,
                             max_peaks=16)


@pytest.fixture(scope="module")
def jax_outputs(jax_estimator, images):
    return jax_estimator.call(images)


def assert_same_people(got, expected):
    assert len(got) == len(expected)
    for people_g, people_e in zip(got, expected):
        assert len(people_g) == len(people_e)
        for g, e in zip(people_g, people_e):
            np.testing.assert_array_equal(g["keypoints"], e["keypoints"])
            np.testing.assert_allclose(g["score"], e["score"], rtol=1e-4)


def test_decode_arrays_match_jax(estimator, jax_estimator, images):
    """One decode at K=16 (no escalation): peak slots, overflow flags and
    limb acceptance."""
    from terran_tpu.ops.pose_decode import unpack_pose_outputs

    decode = jax_estimator._decode_fn(*images.shape[1:3])
    peaks, limbs = decode(jax_estimator.params, images)
    (c_e, s_e, v_e, reg_e, acc_e, o_e) = unpack_pose_outputs(
        np.asarray(peaks), np.asarray(limbs)
    )
    peaks, limbs = estimator._decode_fn()(torch.from_numpy(images))
    (c_g, s_g, v_g, reg_g, acc_g, o_g) = unpack_pose_outputs(
        peaks.numpy(), limbs.numpy()
    )
    np.testing.assert_array_equal(v_g, v_e)
    np.testing.assert_array_equal(o_g, o_e)
    np.testing.assert_array_equal(np.where(v_g[..., None], c_g, 0),
                                  np.where(v_e[..., None], c_e, 0))
    np.testing.assert_allclose(s_g, s_e, rtol=1e-4, atol=1e-6)
    np.testing.assert_array_equal(acc_g, acc_e)


def test_keypoints_match_jax(estimator, jax_outputs, images):
    out = estimator.call(images)
    assert_same_people(out, jax_outputs)
    for people in out:
        for person in people:
            assert set(person) == {"keypoints", "score"}
            assert person["keypoints"].shape == (18, 3)
            assert person["keypoints"].dtype == np.int32


def test_escalation_matches_big_capacity(state_dict, estimator, images):
    esc = OpenPoseEstimator(params=convert_openpose(state_dict),
                            device="cpu", short_side=SHORT_SIDE,
                            max_peaks=4, max_escalations=2)
    out_esc = esc.call(images[:1])
    assert esc.escalation_count >= 1
    assert_same_people(out_esc, estimator.call(images[:1]))


def test_estimation_pad_merge_matches_jax(estimator, jax_estimator):
    from terran_tpu.pose import Estimation as JaxEstimation
    from terran_tpu.utils.batching import merge_factory as jax_merge

    rng = np.random.default_rng(9)
    frames = [rng.integers(0, 255, (SHORT_SIDE, 128, 3), dtype=np.uint8),
              rng.integers(0, 255, (SHORT_SIDE, 100, 3), dtype=np.uint8)]

    task = Estimation.__new__(Estimation)
    task.model = estimator
    task.merge_in, task.merge_out = merge_factory(coord_keys=("keypoints",))
    jax_task = JaxEstimation.__new__(JaxEstimation)
    jax_task.model = jax_estimator
    jax_task.merge_in, jax_task.merge_out = jax_merge(
        coord_keys=("keypoints",)
    )
    assert_same_people(task(frames), jax_task(frames))
    # A single (H, W, 3) image comes back unbatched.
    single = task(frames[0])
    assert isinstance(single, list)
    assert_same_people([single], estimator.call(frames[0][None]))


def test_estimation_loads_the_converted_store(state_dict, images,
                                              jax_outputs, tmp_path,
                                              monkeypatch):
    """``Estimation()`` resolves the registry and reads the ``<id>.npz``
    store that the JAX package writes."""
    monkeypatch.setenv("TERRAN_TPU_HOME", str(tmp_path))
    (tmp_path / "checkpoints").mkdir()
    save_params(tmp_path / "checkpoints" / "11a769ad.npz",
                jax_convert(state_dict))
    loaded = load_checkpoint_params(OpenPoseEstimator.CHECKPOINT_CLASS)
    direct = convert_openpose(state_dict)
    assert loaded.keys() == direct.keys()
    for key in direct:
        assert torch.equal(loaded[key], direct[key]), key

    task = Estimation(device="cpu", short_side=SHORT_SIDE, max_peaks=16)
    assert isinstance(task.model, OpenPoseEstimator)
    assert_same_people(task(images), jax_outputs)


def test_missing_checkpoint_raises(tmp_path, monkeypatch):
    monkeypatch.setenv("TERRAN_TPU_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="11a769ad"):
        load_checkpoint_params(OpenPoseEstimator.CHECKPOINT_CLASS)


def test_keypoint_enum_order():
    assert Keypoint.NOSE.value == 0
    assert Keypoint.L_EAR.value == 17
    assert len(Keypoint) == 18


@pytest.mark.parametrize("size", [(1080, 1920), (333, 501)])
def test_resize_within_one_count_of_cv2(size, rng):
    import cv2

    h, w = size
    images = rng.integers(0, 255, (2, h, w, 3), dtype=np.uint8)
    out_h, out_w, _ = resized_shape(h, w, 184)
    got = resize_bilinear_u8(torch.from_numpy(images), out_h, out_w).numpy()
    for i in range(2):
        ref = cv2.resize(images[i], (out_w, out_h),
                         interpolation=cv2.INTER_LINEAR)
        diff = np.abs(got[i].astype(np.int16) - ref.astype(np.int16))
        assert got[i].shape == ref.shape
        assert diff.max() <= 1
