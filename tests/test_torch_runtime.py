"""Port's config, numerics policy and device names vs the JAX
package's."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from terran_tpu import config as jax_config
from terran_tpu import runtime as jax_runtime
from terran_tpu.face.detection import Detection as JaxDetection
from terran_tpu.utils.convert import convert_retinaface as jax_convert
from terran_tpu_torch import config, runtime
from terran_tpu_torch.face.detection import Detection
from terran_tpu_torch.runtime import Policy, cast_params_for_compute
from terran_tpu_torch.utils.convert import convert_retinaface
from torch_oracle import random_retinaface_state_dict
from torch_port_fixtures import single_torch_thread  # noqa: F401


def test_config_fields_and_defaults_match_jax():
    assert ([(f.name, f.default) for f in dataclasses.fields(config.Config)]
            == [(f.name, f.default)
                for f in dataclasses.fields(jax_config.Config)])


def test_env_overrides_read_the_same_environment():
    env = {"TERRAN_TPU_POSE_SHORT_SIDE": "96",
           "TERRAN_TPU_MAX_PEAKS_PER_PART": "64",
           "TERRAN_TPU_KEYPOINT_THRESHOLD": "0.2",
           "TERRAN_TPU_FUSED_PEAKS": "off"}
    assert (dataclasses.asdict(config.load_config(env))
            == dataclasses.asdict(jax_config.load_config(env)))


@pytest.mark.parametrize("name,dtype", [
    ("bfloat16", torch.bfloat16), ("float32", torch.float32),
])
def test_policy_from_env(name, dtype, monkeypatch):
    monkeypatch.setenv("TERRAN_TPU_COMPUTE_DTYPE", name)
    assert Policy.from_env().compute_dtype == dtype


def test_policy_rejects_non_float(monkeypatch):
    monkeypatch.setenv("TERRAN_TPU_COMPUTE_DTYPE", "int8")
    with pytest.raises(ValueError):
        Policy.from_env()


def test_cast_params_for_compute():
    sd = {"a.weight": torch.ones(2), "b.weight": torch.ones(2),
          "steps": torch.ones(2, dtype=torch.int64)}
    out = cast_params_for_compute(sd, torch.bfloat16, keep_f32=("b.",))
    assert out["a.weight"].dtype == torch.bfloat16
    assert out["b.weight"].dtype == torch.float32
    assert out["steps"].dtype == torch.int64
    assert cast_params_for_compute(sd, torch.float32) == sd


def test_policy_fields_in_the_jax_order():
    assert ([f.name for f in dataclasses.fields(Policy)]
            == [f.name for f in dataclasses.fields(jax_runtime.Policy)]
            == ["param_dtype", "compute_dtype"])
    assert Policy().param_dtype == torch.float32
    assert Policy().compute_dtype == torch.bfloat16
    # Positional construction means the same in both packages.
    got = Policy(torch.float32, torch.float16)
    exp = jax_runtime.Policy(jnp.float32, jnp.float16)
    assert (got.param_dtype, got.compute_dtype) == (torch.float32,
                                                    torch.float16)
    assert (exp.param_dtype, exp.compute_dtype) == (jnp.float32, jnp.float16)


@pytest.fixture
def restore_policies():
    """Both packages' default policies as they were, after the test."""
    saved = runtime._default_policy, jax_runtime._default_policy
    yield
    runtime._default_policy, jax_runtime._default_policy = saved


def test_set_default_policy_is_read_back(restore_policies):
    policy = Policy(compute_dtype=torch.float16)
    runtime.set_default_policy(policy)
    assert runtime.default_policy() is policy
    jax_policy = jax_runtime.Policy(compute_dtype=jnp.float16)
    jax_runtime.set_default_policy(jax_policy)
    assert jax_runtime.default_policy() is jax_policy


SHORT_SIDE = 96
TOP_K = 1024


def test_float32_default_policy_reaches_detection(restore_policies):
    """Detection built with no compute_dtype runs the default policy's:
    bfloat16 weights under a bfloat16 policy; under a float32 policy in
    both packages, the same faces as the JAX package's on the same random
    weights. Tolerance, as in tests/test_torch_detection_api.py: the same
    faces in the same order, scores within 1e-5, int32 boxes and landmarks
    within one count."""
    state_dict = random_retinaface_state_dict(np.random.default_rng(0))
    params = convert_retinaface(state_dict)
    runtime.set_default_policy(Policy(compute_dtype=torch.bfloat16))
    half = Detection(params=params, device="cpu", short_side=SHORT_SIDE,
                     top_k=TOP_K)
    assert {p.dtype for p in half.model.model.parameters()} == {
        torch.bfloat16}

    runtime.set_default_policy(Policy(compute_dtype=torch.float32))
    jax_runtime.set_default_policy(
        jax_runtime.Policy(compute_dtype=jnp.float32))
    task = Detection(params=params, device="cpu", short_side=SHORT_SIDE,
                     top_k=TOP_K)
    assert {p.dtype for p in task.model.model.parameters()} == {
        torch.float32}
    jax_task = JaxDetection(params=jax_convert(state_dict),
                            short_side=SHORT_SIDE, top_k=TOP_K)
    batch = np.random.default_rng(6).integers(
        0, 255, (2, SHORT_SIDE, 160, 3), dtype=np.uint8)
    got, exp = task(batch), jax_task(batch)
    assert sum(len(faces) for faces in got) > 0, "no faces to compare"
    assert [len(faces) for faces in got] == [len(faces) for faces in exp]
    for faces_g, faces_e in zip(got, exp):
        for g, e in zip(faces_g, faces_e):
            assert abs(g["score"] - e["score"]) <= 1e-5
            for key in ("bbox", "landmarks"):
                assert g[key].dtype == np.int32
                assert np.abs(g[key] - e[key]).max() <= 1


NO_CARD = "no CUDA device is available"


@pytest.mark.parametrize("name", ["available_devices", "platform",
                                  "default_device"])
def test_device_names_raise_without_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=NO_CARD):
        getattr(runtime, name)()


def test_device_names_on_two_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert runtime.available_devices() == [torch.device("cuda", 0),
                                           torch.device("cuda", 1)]
    assert runtime.platform() == "gpu"
    assert runtime.default_device() == torch.device("cuda")
