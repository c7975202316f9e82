"""The port's mesh layer in one process, on the CPU.

The host math of ``parallel/spatial.py`` against ``terran_tpu``'s on the
same numpy inputs (exact), ``pad_batch_to_multiple`` and this rank's rows,
``initialize_multi_host``'s strict and best-effort rules
(``tests/test_multihost.py``'s), ``create_mesh``'s checks, and a world-1
gloo mesh under the pipeline, which must give the no-mesh pipeline's
results exactly. The multi-rank semantics are
``tests/test_torch_multirank.py``'s.
"""

import socket
import time

import numpy as np
import pytest
import torch
import torch.distributed as dist

from terran_tpu.parallel import mesh as jax_mesh
from terran_tpu.parallel import spatial as jax_spatial
from terran_tpu_torch.parallel import (
    create_mesh, global_batch_from_local, initialize_multi_host,
    local_results, pad_batch_to_multiple, shard_batch, shard_params,
    slab_layout,
)
from terran_tpu_torch.parallel.mesh import own_rows
from terran_tpu_torch.parallel.spatial import (
    ext_anchor_meta, slab_candidates,
)
from terran_tpu_torch.pipeline import PerceptionPipeline
from terran_tpu_torch.utils.convert import (
    convert_arcface, convert_openpose, convert_retinaface,
)
from torch_oracle import (
    random_arcface_state_dict, random_openpose_state_dict,
    random_retinaface_state_dict,
)
from torch_port_fixtures import single_torch_thread  # noqa: F401

SLAB, HALO, WIDTH = 64, 32, 96


@pytest.fixture
def no_group():
    """No process group before the test, and none left after it."""
    assert not dist.is_initialized()
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def world_of_one():
    """A CPU mesh of this process alone (gloo over a loopback store)."""
    assert not dist.is_initialized()
    mesh = create_mesh(devices="cpu")
    yield mesh
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# Host math against terran_tpu
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("height,n", [(2160, 8), (256, 4), (1, 8), (200, 4),
                                      (1080, 1), (2160, 4)])
def test_slab_layout_matches_jax(height, n):
    assert slab_layout(height, n) == jax_spatial.slab_layout(height, n)


@pytest.mark.parametrize("slab_h,width,halo", [(64, 96, 32), (96, 90, 64),
                                                (32, 32, 32)])
def test_ext_anchor_meta_matches_jax(slab_h, width, halo):
    got = ext_anchor_meta(slab_h, width, halo)
    expected = jax_spatial.ext_anchor_meta(slab_h, width, halo)
    assert len(got) == len(expected) == 5
    for g, e in zip(got, expected):
        assert g.dtype == e.dtype
        np.testing.assert_array_equal(g, e)


@pytest.mark.parametrize("device_index", range(4))
@pytest.mark.parametrize("valid,threshold,local_top_k", [
    ((4 * SLAB, WIDTH), 0.3, 16),       # the whole frame, overflowing
    ((4 * SLAB - 40, WIDTH - 24), 0.5, 64),  # padded margins masked
    ((4 * SLAB, WIDTH), 0.0, 4096),     # threshold 0 keeps non-owned out
])
def test_slab_candidates_match_jax(device_index, valid, threshold,
                                   local_top_k):
    import jax.numpy as jnp

    anchors = ext_anchor_meta(SLAB, WIDTH, HALO)[0]
    a = len(anchors)
    local_top_k = min(local_top_k, a)
    rng = np.random.default_rng(device_index)
    scores = rng.uniform(0, 1, a).astype(np.float32)
    scores[::7] = np.float32(0.75)  # ties
    boxes = rng.uniform(-50, 150, (a, 4)).astype(np.float32)
    landmarks = rng.uniform(-50, 150, (a, 5, 2)).astype(np.float32)
    kwargs = dict(device_index=device_index, slab_h=SLAB, halo=HALO,
                  width=WIDTH, valid_h=valid[0], valid_w=valid[1],
                  threshold=threshold, local_top_k=local_top_k)
    got = slab_candidates(torch.from_numpy(scores), torch.from_numpy(boxes),
                          torch.from_numpy(landmarks), **kwargs)
    expected = jax_spatial.slab_candidates(
        jnp.asarray(scores), jnp.asarray(boxes), jnp.asarray(landmarks),
        **dict(kwargs, device_index=jnp.asarray(device_index)))
    for name, g, e in zip(("boxes", "landmarks", "scores", "overflow"),
                          got, expected):
        np.testing.assert_array_equal(g.numpy(), np.asarray(e),
                                      err_msg=name)


def test_every_anchor_owned_once_and_threshold_zero_keeps_out_the_rest():
    """Over 4 slabs the owned anchors at threshold 0 are exactly the
    whole frame's (``tests/test_spatial.py``'s two invariants)."""
    from terran_tpu_torch.models.retinaface import anchors_for_shape

    a = len(ext_anchor_meta(SLAB, WIDTH, HALO)[0])
    ones = torch.ones(a)
    total = 0
    for i in range(4):
        _, _, scores, _ = slab_candidates(
            ones, torch.zeros(a, 4), torch.zeros(a, 5, 2), device_index=i,
            slab_h=SLAB, halo=HALO, width=WIDTH, valid_h=4 * SLAB,
            valid_w=WIDTH, threshold=0.0, local_top_k=a)
        total += int(torch.isfinite(scores).sum())
    assert total == len(anchors_for_shape(4 * SLAB, WIDTH))


@pytest.mark.parametrize("n,multiple", [(3, 4), (8, 4), (1, 8), (5, 2)])
def test_pad_batch_to_multiple_and_own_rows(n, multiple):
    batch = np.arange(n * 2).reshape(n, 2)
    padded, count = pad_batch_to_multiple(batch, multiple)
    expected, expected_count = jax_mesh.pad_batch_to_multiple(batch, multiple)
    assert count == expected_count == n
    np.testing.assert_array_equal(padded, expected)
    per = padded.shape[0] // multiple

    class Rank:
        size = multiple

    for rank in range(multiple):
        Rank.rank = rank
        rows = padded[rank * per:(rank + 1) * per]
        np.testing.assert_array_equal(own_rows(batch, Rank), rows)
        assert torch.equal(own_rows(torch.from_numpy(batch), Rank),
                           torch.from_numpy(rows))


# ---------------------------------------------------------------------------
# initialize_multi_host and create_mesh
# ---------------------------------------------------------------------------

def _closed_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_initialize_multi_host_strict_with_explicit_args(no_group):
    # An unreachable coordinator raises within the timeout instead of
    # falling back to a single process.
    start = time.monotonic()
    with pytest.raises(Exception):
        initialize_multi_host(
            coordinator_address=f"127.0.0.1:{_closed_port()}",
            num_processes=2, process_id=1, initialization_timeout=2)
    assert time.monotonic() - start < 60
    assert not dist.is_initialized()


@pytest.mark.parametrize("kwargs", [
    {"num_processes": 2, "process_id": 1},
    {"coordinator_address": "127.0.0.1:1"},
])
def test_initialize_multi_host_strict_with_partial_args(no_group, kwargs):
    with pytest.raises(ValueError):
        initialize_multi_host(**kwargs)
    assert not dist.is_initialized()


def test_initialize_multi_host_default_is_best_effort(no_group,
                                                      monkeypatch):
    for key in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(key, raising=False)
    initialize_multi_host()  # no coordinator configured: a no-op
    assert not dist.is_initialized()

    # torchrun's variables: a world of one over them.
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_closed_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    initialize_multi_host(initialization_timeout=30)
    assert dist.is_initialized() and dist.get_world_size() == 1
    assert dist.get_backend() == "gloo"
    initialize_multi_host()  # a group exists: a no-op


def test_create_mesh_makes_a_world_of_one(no_group):
    mesh = create_mesh(devices="cpu")
    assert (mesh.size, mesh.rank, mesh.ranks) == (1, 0, (0,))
    assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    assert mesh.axis_name == "data"
    with pytest.raises(ValueError, match="requested 2 devices, have 1"):
        create_mesh(2, devices="cpu")


@pytest.mark.parametrize("device", ["cuda:0", "cuda"])
def test_cuda_device_on_a_gloo_group_raises(no_group, device):
    # No staging through the host: the check precedes any CUDA call, so it
    # runs here without a card.
    create_mesh(devices="cpu")
    with pytest.raises(ValueError, match="cannot carry cuda:0"):
        create_mesh(devices=device)


def test_shard_and_feed_at_world_one(world_of_one):
    mesh = world_of_one
    batch = np.arange(12, dtype=np.float32).reshape(4, 3)
    sharded = shard_batch(batch, mesh)
    assert sharded.shape == (4, 3)
    np.testing.assert_array_equal(local_results(sharded, mesh), batch)
    fed = global_batch_from_local(batch, mesh)
    np.testing.assert_array_equal(local_results(fed), batch)
    # A replicated result comes back whole.
    np.testing.assert_array_equal(local_results(torch.from_numpy(batch)),
                                  batch)
    params = {"a": np.ones((2, 2), np.float32),
              "inner": {"b": torch.arange(3)}}
    placed = shard_params(params, mesh)
    assert placed["a"].device == mesh.device
    assert torch.equal(placed["inner"]["b"], torch.arange(3))
    assert placed["inner"]["b"] is not params["inner"]["b"]


def test_pose_forward_checks_the_mesh_device():
    # The check precedes the model, so no model or card is needed.
    from terran_tpu_torch.ops.pose_decode import forward_and_find_peaks
    from terran_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(group=None, ranks=(0,), rank=0,
                device=torch.device("cuda", 0))
    images = torch.zeros((1, 8, 8, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="not on the mesh's cuda:0"):
        forward_and_find_peaks(None, images, 0.1, 4, False, mesh=mesh)


# ---------------------------------------------------------------------------
# The pipeline under a world-1 mesh
# ---------------------------------------------------------------------------

# tests/test_torch_pipeline.py's cheap configuration with 2 face slots.
CHEAP = {"top_k": 16, "max_faces": 2, "max_peaks": 8, "max_escalations": 0,
         "det_short_side": 64, "pose_short_side": 48}
KEYS = ("boxes", "landmarks", "scores", "mask", "det_overflow", "embeddings",
        "embeddings_mask", "pose_overflow")


@pytest.fixture(scope="module")
def params():
    rng = np.random.default_rng(33)
    return (convert_retinaface(random_retinaface_state_dict(rng)),
            convert_arcface(random_arcface_state_dict(rng)),
            convert_openpose(random_openpose_state_dict(rng)))


def assert_same(got, expected):
    for key in KEYS:
        np.testing.assert_array_equal(got[key], expected[key], err_msg=key)
    assert len(got["poses"]) == len(expected["poses"])
    for a, b in zip(got["poses"], expected["poses"]):
        assert len(a) == len(b)
        for ha, hb in zip(a, b):
            np.testing.assert_array_equal(ha["keypoints"], hb["keypoints"])
            assert ha["score"] == hb["score"]


@pytest.mark.parametrize("plan", ["device", "host"])
def test_world_one_mesh_pipeline_equals_no_mesh(world_of_one, params, plan):
    kwargs = dict(CHEAP, transfer_plan=plan, host_resize="exact")
    single = PerceptionPipeline(*params, device="cpu", **kwargs)
    meshed = PerceptionPipeline(*params, mesh=world_of_one, **kwargs)
    assert meshed.device == world_of_one.device and meshed.mesh is world_of_one
    # The JAX class's dispatch defaults under a mesh.
    assert meshed.embed_dispatch == meshed.limb_dispatch == "adaptive"
    frames = np.random.default_rng(1).integers(0, 255, (2, 96, 128, 3),
                                               dtype=np.uint8)
    expected = single.process_batch(frames)
    assert expected["mask"].any()
    assert_same(meshed.process_batch(frames), expected)
    # process_stream turns prefetch off under a mesh, and keeps order.
    streamed = list(meshed.process_stream([frames, frames[:1]],
                                          prefetch=True))
    assert_same(streamed[0], expected)
    assert streamed[1]["boxes"].shape[0] == 1
    assert meshed.warmup(1, 96, 128) == single.warmup(1, 96, 128)
    with pytest.raises(ValueError, match="not the mesh's"):
        PerceptionPipeline(*params, mesh=world_of_one, device="meta",
                           **kwargs)
