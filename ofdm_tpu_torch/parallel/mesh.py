"""Device mesh for the distributed transceiver (port of ofdm_tpu/parallel/mesh.py).

The transceiver scales two ways, as the JAX package's does:

- ``data`` axis: independent channels, frames or capture buffers, with no
  communication between them;
- ``time`` axis: sequence parallelism over long sample streams.  Sliding
  correlation windows need the first K - 1 samples of the right neighbour's
  shard (K = 80 taps of the locking template), exchanged around a ring.

JAX drives every device from one process through ``shard_map``.  Here each
rank is one process with one device: the mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with ``mesh_dim_names=("data",
"time")`` over the world's ranks, each rank holds plain local tensors (the
kernels take their ``data_ptr()``), and the collectives are explicit c10d
calls on the mesh's groups (``parallel/halo.py``).  CUDA ranks use NCCL, one
card each; CPU ranks use gloo.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

DATA_AXIS = "data"
TIME_AXIS = "time"
DEVICE_TYPES = ("cuda", "cpu")

# one process group per mesh that is smaller than the world, keyed by its
# ranks: the group of a sum over the whole mesh (the world's group serves a
# mesh that spans it)
_MESH_GROUPS: dict = {}


def backend_for(device_type: str) -> str:
    """The c10d backend of a device type: NCCL for CUDA, gloo for the CPU."""
    if device_type not in DEVICE_TYPES:
        raise ValueError(f"device_type must be one of {DEVICE_TYPES}, got "
                         f"{device_type!r}")
    return "nccl" if device_type == "cuda" else "gloo"


def local_rank() -> int:
    """This process's rank on its host: torchrun's LOCAL_RANK, else the
    global rank (one host)."""
    return int(os.environ.get("LOCAL_RANK", dist.get_rank()))


def _cards() -> int:
    """The number of CUDA devices this process sees; raises where none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("a CUDA mesh needs a CUDA device, and none is "
                           "visible; pass device_type=\"cpu\" for a gloo mesh")
    return n


def rank_device(device_type: str = "cuda") -> torch.device:
    """This rank's device: ``cuda:(local_rank % device_count)``, or the CPU.

    Raises where CUDA is absent, and where this host runs more CUDA ranks
    than it has cards: NCCL refuses two ranks on one device."""
    backend_for(device_type)
    if device_type == "cpu":
        return torch.device("cpu")
    n = _cards()
    on_host = int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))
    if on_host > n:
        raise RuntimeError(f"{on_host} CUDA ranks on a host with {n} card(s): "
                           "NCCL takes one rank per card")
    return torch.device("cuda", local_rank() % n)


def _start_single(device_type: str) -> None:
    """A world-size-1 process group on a local store (the one-process case
    that JAX's make_mesh covers without any runtime)."""
    backend = backend_for(device_type)
    if device_type == "cuda":
        _cards()
        torch.cuda.set_device(0)
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def make_mesh(n_data: int | None = None, n_time: int = 1,
              device_type: str = "cuda") -> DeviceMesh:
    """Mesh over the world's first ``n_data * n_time`` ranks, data-major,
    with ("data", "time") dims.  Defaults to every rank on the data axis.

    Every rank calls it (the groups are made collectively).  With no process
    group yet, a world of one process starts a world-size-1 group on a
    local store; a larger world must be started first
    (``parallel.distributed.initialize``).  Raises where the mesh exceeds
    the world, and on CUDA where ranks outnumber cards."""
    backend_for(device_type)
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) != 1:
            raise RuntimeError("start the process group first "
                               "(parallel.distributed.initialize)")
        _start_single(device_type)
    world = dist.get_world_size()
    if n_data is None:
        n_data = world // n_time
    if n_data < 1 or n_time < 1 or n_data * n_time > world:
        raise ValueError(f"mesh {n_data}x{n_time} exceeds {world} ranks")
    if device_type == "cuda":
        torch.cuda.set_device(rank_device("cuda"))
    ranks = torch.arange(n_data * n_time).reshape(n_data, n_time)
    mesh = DeviceMesh(device_type, ranks, mesh_dim_names=(DATA_AXIS, TIME_AXIS))
    key = tuple(ranks.flatten().tolist())
    if len(key) < world and key not in _MESH_GROUPS:
        _MESH_GROUPS[key] = dist.new_group(list(key))
    return mesh


def _require(mesh: DeviceMesh) -> None:
    if mesh.get_coordinate() is None:
        raise RuntimeError(f"rank {dist.get_rank()} is not in the mesh "
                           f"{mesh.mesh.tolist()}")


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    """Number of ranks along ``axis`` (JAX's ``mesh.shape[axis]``)."""
    return mesh.size(mesh.mesh_dim_names.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along ``axis`` (JAX's ``lax.axis_index``)."""
    _require(mesh)
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's line along ``axis``."""
    _require(mesh)
    return mesh.get_group(axis)


def mesh_group(mesh: DeviceMesh):
    """The process group of the whole mesh (None, the world's group, when
    the mesh spans the world)."""
    _require(mesh)
    key = tuple(mesh.mesh.flatten().tolist())
    return None if len(key) == dist.get_world_size() else _MESH_GROUPS[key]


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards live on."""
    return rank_device(mesh.device_type)


@dataclasses.dataclass(frozen=True)
class Sharding:
    """This rank's block of a global array: the leading axis split over
    ``data`` and, when ``time`` is set, the last axis split over ``time``,
    on ``device``.  ``(index, count)`` per split axis."""
    data: tuple[int, int]
    time: tuple[int, int] | None
    device: torch.device

    def index(self, shape) -> tuple:
        """The slices of this rank's block of an array of ``shape``."""
        def block(n: int, split: tuple[int, int], what: str) -> slice:
            i, count = split
            if n % count:
                raise ValueError(f"{what} {n} does not divide over {count} "
                                 "ranks")
            return slice(i * (n // count), (i + 1) * (n // count))
        idx = [block(shape[0], self.data, "leading axis")]
        if self.time is not None:
            idx += [slice(None)] * (len(shape) - 2)
            idx.append(block(shape[-1], self.time, "last axis"))
        return tuple(idx)


def data_sharding(mesh: DeviceMesh) -> Sharding:
    """Batch-of-channels sharding: rows over the data axis, replicated along
    time."""
    return Sharding((axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)),
                    None, mesh_device(mesh))


def time_sharding(mesh: DeviceMesh) -> Sharding:
    """Sample-stream sharding: [B, T] with B over data and T over time."""
    return Sharding((axis_index(mesh, DATA_AXIS), axis_size(mesh, DATA_AXIS)),
                    (axis_index(mesh, TIME_AXIS), axis_size(mesh, TIME_AXIS)),
                    mesh_device(mesh))


def shard(x: torch.Tensor, sharding: Sharding) -> torch.Tensor:
    """This rank's block of the global array ``x`` on its device (JAX's
    ``device_put`` with a NamedSharding): a view where ``x`` is there
    already."""
    return x[sharding.index(x.shape)].to(sharding.device)
