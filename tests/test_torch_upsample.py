"""Port's x8 bicubic FIR vs the JAX op and vs torch's own bicubic."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F
import jax.numpy as jnp

from terran_tpu.ops.upsample import _phase_table as jax_phase_table
from terran_tpu.ops.upsample import upsample_bicubic as jax_upsample
from terran_tpu_torch.ops.upsample import _phase_table, upsample_bicubic
from torch_port_fixtures import single_torch_thread  # noqa: F401


def test_phase_table_is_the_float32_jax_table():
    bases, weights = _phase_table(8)
    jax_bases, jax_weights = jax_phase_table(8)
    assert bases == jax_bases
    np.testing.assert_array_equal(
        np.asarray(weights, np.float32), np.asarray(jax_weights, np.float32)
    )


@pytest.mark.parametrize("shape", [(1, 7, 9, 3), (2, 16, 26, 5)])
def test_matches_jax(shape, rng):
    x = rng.normal(size=shape).astype(np.float32)
    expected = np.asarray(jax_upsample(jnp.asarray(x), 8))
    got = upsample_bicubic(torch.from_numpy(x), 8).numpy()
    assert got.shape == expected.shape
    # Same taps and order; XLA may contract a multiply-add, so an ulp.
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)


def test_matches_torch_bicubic(rng):
    x = rng.normal(size=(2, 12, 17, 4)).astype(np.float32)
    got = upsample_bicubic(torch.from_numpy(x), 8).numpy()
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    ref = F.interpolate(nchw, scale_factor=8, mode="bicubic",
                        align_corners=False).permute(0, 2, 3, 1).numpy()
    # F.interpolate sums the 16 taps in another order.
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


def test_single_axis_and_batchless_layout(rng):
    x = rng.normal(size=(6, 5, 2)).astype(np.float32)
    got = upsample_bicubic(torch.from_numpy(x), 8, axes=(0, 1)).numpy()
    expected = np.asarray(jax_upsample(jnp.asarray(x), 8, axes=(0, 1)))
    np.testing.assert_allclose(got, expected, rtol=1e-6, atol=1e-7)
