"""Scale-out layer over ``torch.distributed``, one process per card:
batch data parallelism over a 1-D mesh (``mesh``) and single-frame
spatial sharding with halo exchange (``spatial``)."""

from terran_tpu_torch.parallel.mesh import (  # noqa: F401
    DATA_AXIS,
    Mesh,
    ShardedBatch,
    create_mesh,
    global_batch_from_local,
    initialize_multi_host,
    local_results,
    pad_batch_to_multiple,
    shard_batch,
    shard_params,
)
from terran_tpu_torch.parallel.spatial import (  # noqa: F401
    SpatialShardedDetector,
    make_spatial_detect_fn,
    slab_layout,
)
