"""Multi-process start-up (port of ofdm_tpu/parallel/distributed.py).

One process per rank; ``torch.distributed`` joins them over TCP.  A single
process needs no call: ``make_mesh`` starts a world of one by itself.

    from ofdm_tpu_torch.parallel.distributed import initialize, global_mesh
    initialize()                    # torchrun's RANK / WORLD_SIZE / MASTER_ADDR
    initialize(coordinator="host0:1234", num_processes=4, process_id=i)
    mesh = global_mesh(n_time=2)

The backend follows the device: NCCL where CUDA is available, gloo
elsewhere, or the one named.  A failed NCCL start raises; nothing retries
on gloo.  ``parallel/dist_worker.py`` runs one rank of a localhost world.
"""

from __future__ import annotations

import logging
import os

import torch
import torch.distributed as dist

from .mesh import make_mesh, rank_device

log = logging.getLogger("ofdm_tpu_torch.distributed")

_ENV = ("RANK", "WORLD_SIZE", "MASTER_ADDR")


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> bool:
    """Start the process group; returns True if a multi-process world was
    started.

    With no arguments it reads torchrun's RANK, WORLD_SIZE and MASTER_ADDR
    (and MASTER_PORT) and returns False where they are absent: a single
    process.  Otherwise it joins ``tcp://coordinator`` as rank
    ``process_id`` of ``num_processes``.  ``backend`` None picks NCCL where
    CUDA is available (setting this rank's card first), else gloo."""
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None and num_processes is None and process_id is None:
        if not all(k in os.environ for k in _ENV):
            log.debug("no RANK/WORLD_SIZE/MASTER_ADDR: single process")
            return False
        init_method, world, rank = "env://", int(os.environ["WORLD_SIZE"]), \
            int(os.environ["RANK"])
    else:
        if coordinator is None or num_processes is None or process_id is None:
            raise ValueError("initialize needs coordinator, num_processes and "
                             "process_id together")
        init_method, world, rank = f"tcp://{coordinator}", num_processes, \
            process_id
    if backend == "nccl":
        n = torch.cuda.device_count()
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank)) % max(n, 1))
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world)
    if backend == "nccl":
        rank_device("cuda")         # raises where ranks outnumber cards
    log.info("distributed runtime: rank %d/%d (%s)", dist.get_rank(),
             dist.get_world_size(), backend)
    return dist.get_world_size() > 1


def global_mesh(n_time: int = 1, device_type: str = "cuda"):
    """Mesh over every rank of the world (a world of one where no group was
    started), data-major."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh(n_data=world // n_time, n_time=n_time,
                     device_type=device_type)
