"""Process groups and batch sharding: the port's scale-out layer.

The port of ``terran_tpu/parallel/mesh.py`` in PyTorch's own idiom: one
process per card under ``torch.distributed``. A :class:`Mesh` is a
process group, this process's place in it and its device. A batch is
split over the ranks along its leading axis; each rank runs only its own
rows, and the fixed-shape results are all-gathered in rank order, so that
the same call on every rank returns what the single-device path returns.

NCCL carries CUDA tensors and gloo the CPU tensors of the tests. A group
whose backend cannot carry the mesh's device raises: nothing is staged
through the host.

JAX's ``batch_sharding`` and ``replicated_sharding`` are ``NamedSharding``s
of single-controller arrays, which torch does not have; they are not
ported. Here a :class:`ShardedBatch` marks this rank's rows of a batch,
and a plain tensor is replicated.
"""

import datetime
import os
from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclass(frozen=True, eq=False)
class Mesh:
    """A 1-D mesh: ``group``, the global ranks in mesh order (``ranks``),
    this process's index among them (``rank``) and its ``device``."""

    group: object
    ranks: tuple
    rank: int
    device: torch.device
    axis_name: str = DATA_AXIS

    @property
    def size(self):
        return len(self.ranks)

    @property
    def backend(self):
        return dist.get_backend(self.group)


@dataclass(frozen=True, eq=False)
class ShardedBatch:
    """This rank's rows (``local``, on the mesh's device) of a batch whose
    leading axis is split evenly over ``mesh``, rank 0's rows first."""

    local: torch.Tensor
    mesh: Mesh

    @property
    def shape(self):
        return ((self.mesh.size * self.local.shape[0],)
                + tuple(self.local.shape[1:]))


def _rank_device(device):
    """This process's device: ``device``, or ``cuda:{LOCAL_RANK}`` for None
    and for a CUDA device without an index."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    return device


def _check_backend(group, device):
    """Raise unless ``group``'s backend carries ``device``'s tensors
    itself: NCCL for CUDA, gloo for the CPU. Makes no CUDA call."""
    backend = dist.get_backend(group)
    needed = {"cuda": "nccl", "cpu": "gloo"}.get(device.type)
    if needed is None or needed not in backend:
        raise ValueError(
            f"a {backend!r} process group cannot carry {device} tensors "
            "without staging them through the host; use nccl for CUDA "
            "devices and gloo for the CPU"
        )


def _init_world_of_one(device):
    """This process as a world of one, over a loopback store on a free
    port: NCCL for a CUDA device, gloo for the CPU."""
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            store=store, world_size=1, rank=0)


def create_mesh(num_devices=None, axis_name=DATA_AXIS, devices=None):
    """A 1-D mesh over the whole world, or over its first ``num_devices``
    ranks. Every rank calls it; a rank outside a smaller mesh gets None.

    ``devices``: this rank's device (default ``cuda:{LOCAL_RANK}``; the
    CPU only when asked). Where no process group exists, this process
    becomes a world of one, so that ``create_mesh()`` works on one card as
    it does in JAX.
    """
    device = _rank_device(devices)
    if not dist.is_initialized():
        _init_world_of_one(device)
    world = dist.get_world_size()
    if num_devices is not None and num_devices > world:
        raise ValueError(f"requested {num_devices} devices, have {world}")
    if num_devices is None or num_devices == world:
        group, ranks = dist.group.WORLD, tuple(range(world))
    else:
        ranks = tuple(range(num_devices))
        group = dist.new_group(list(ranks))
        if dist.get_rank() not in ranks:
            return None
    _check_backend(group, device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    return Mesh(group=group, ranks=ranks, rank=ranks.index(dist.get_rank()),
                device=device, axis_name=axis_name)


def pad_batch_to_multiple(batch, multiple):
    """Pad the leading axis up to a multiple (repeating the last element so
    padded work is realistic); returns (padded, valid_count)."""
    n = batch.shape[0]
    remainder = n % multiple
    if remainder == 0:
        return batch, n
    pad = multiple - remainder
    filler = np.repeat(batch[-1:], pad, axis=0)
    return np.concatenate([batch, filler], axis=0), n


def own_rows(batch, mesh):
    """This rank's rows of ``batch`` (a numpy array or tensor) padded as
    :func:`pad_batch_to_multiple` pads it to a multiple of the mesh size;
    only these rows are copied."""
    per = -(-len(batch) // mesh.size)
    start = mesh.rank * per
    rows = batch[start:start + per]
    short = per - len(rows)
    if short == 0:
        return rows
    last = batch[-1:]
    if isinstance(batch, torch.Tensor):
        fill = last.expand((short,) + tuple(last.shape[1:]))
        return torch.cat([rows, fill])
    return np.concatenate([rows, np.repeat(last, short, axis=0)])


def _tensor(value):
    if isinstance(value, torch.Tensor):
        return value
    return torch.from_numpy(np.ascontiguousarray(value))


def shard_params(params, mesh):
    """A copy of ``params`` (a mapping, possibly nested, of tensors or
    arrays) on this rank's device, broadcast from the mesh's first rank so
    that every replica holds the same values."""
    placed = {}
    for name, value in params.items():
        if isinstance(value, Mapping):
            placed[name] = shard_params(value, mesh)
            continue
        tensor = _tensor(value).detach().to(mesh.device, copy=True)
        tensor = tensor.contiguous()
        dist.broadcast(tensor, src=mesh.ranks[0], group=mesh.group)
        placed[name] = tensor
    return placed


def shard_batch(batch, mesh):
    """This rank's rows of a host batch, on its device, as a
    :class:`ShardedBatch`; the leading axis must divide by the mesh
    size."""
    if len(batch) % mesh.size:
        raise ValueError(f"a batch of {len(batch)} does not split over "
                         f"{mesh.size} ranks; pad it first "
                         "(pad_batch_to_multiple)")
    return global_batch_from_local(own_rows(batch, mesh), mesh)


def initialize_multi_host(coordinator_address=None, num_processes=None,
                          process_id=None, initialization_timeout=None):
    """Join the job's process group over ``tcp://{coordinator_address}``.

    With explicit arguments this is strict: all three are needed, and a
    coordinator that cannot be reached within ``initialization_timeout``
    seconds raises, because silently proceeding single-process would
    shard a job the operator asked to distribute. With all-None arguments
    it is best-effort: it initialises from torchrun's ``MASTER_ADDR``,
    ``WORLD_SIZE`` and ``RANK`` when they are set, and otherwise, or when
    a group already exists, does nothing. The group carries CUDA tensors
    over NCCL and CPU ones over gloo where a card is visible, and CPU ones
    over gloo elsewhere.
    """
    explicit = any(a is not None
                   for a in (coordinator_address, num_processes, process_id))
    if explicit:
        if None in (coordinator_address, num_processes, process_id):
            raise ValueError("initialize_multi_host needs "
                             "coordinator_address, num_processes and "
                             "process_id together")
        kwargs = {"init_method": f"tcp://{coordinator_address}",
                  "world_size": num_processes, "rank": process_id}
    elif dist.is_initialized() or not all(
            key in os.environ for key in ("MASTER_ADDR", "WORLD_SIZE",
                                          "RANK")):
        return
    else:
        kwargs = {"init_method": "env://"}
    if initialization_timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=initialization_timeout)
    backend = "cpu:gloo,cuda:nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, **kwargs)


def global_batch_from_local(local_batch, mesh, axis_name=DATA_AXIS):
    """This process's rows of a global batch, as a :class:`ShardedBatch` on
    its device. Multi-host input path: each rank's readers decode only its
    own rows, and no rank's inputs cross to another; every rank feeds the
    same number of rows."""
    return ShardedBatch(_tensor(local_batch).to(mesh.device), mesh)


def local_results(out, mesh=None):
    """This process's part of a result, as one host array: the rows it fed
    for a :class:`ShardedBatch`, the whole of a replicated tensor or
    array."""
    if isinstance(out, ShardedBatch):
        if mesh is not None and out.mesh is not mesh:
            raise ValueError("the batch is sharded over another mesh")
        out = out.local
    if isinstance(out, torch.Tensor):
        return out.cpu().numpy()
    return np.asarray(out)


def all_gather_rows(tensor, mesh):
    """Every rank's ``tensor`` stacked along the leading axis in rank order,
    on every rank, as JAX's ``all_gather(..., tiled=True)``. On a card it
    is ordered on the current stream."""
    tensor = tensor.contiguous()
    out = torch.empty((mesh.size * tensor.shape[0],) + tuple(tensor.shape[1:]),
                      dtype=tensor.dtype, device=tensor.device)
    dist.all_gather_into_tensor(out, tensor, group=mesh.group)
    return out


def all_reduce_max(tensor, mesh):
    """The elementwise maximum of ``tensor`` over the mesh, on every
    rank."""
    tensor = tensor.clone()
    dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=mesh.group)
    return tensor
