"""Port's config and numerics policy vs the JAX package's."""

import dataclasses

import pytest
import torch

from terran_tpu import config as jax_config
from terran_tpu_torch import config
from terran_tpu_torch.runtime import Policy, cast_params_for_compute


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
