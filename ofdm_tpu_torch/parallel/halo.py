"""Collectives of the time-sharded receiver (port of ofdm_tpu/parallel/halo.py).

The sliding sync correlation needs each time shard to see the first K - 1
samples of its right neighbour's shard, and the symbol chunking whole
symbols past its end: both come from one right-to-left halo exchange around
the time ring (``right_halo``).  The channel's convolution needs the left
neighbour's last taps - 1 samples (``left_halo``).  The frame start is the
first global lag of maximal correlation power, found with one
``all_reduce(MAX)`` of a packed int64 key (``global_argmax``,
``global_key_max``).

Each helper counts its calls and the bytes this rank sends, by kind, in
``COUNTS`` (``counts()``, ``reset_counts()``): the port's version of the JAX
tests' audit of the compiled HLO's collectives.  On a line of one rank the
ring exchanges make no call and hand the shard its own head or tail, as
``ppermute`` does (gloo and NCCL cannot send to the sender); the reductions
and gathers always make theirs.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels.align import argmax_keys, key_lag
from .mesh import TIME_AXIS, axis_group, axis_index, axis_size, mesh_group

KINDS = ("permute", "all_reduce", "all_gather")
COUNTS = {kind: {"calls": 0, "bytes": 0} for kind in KINDS}


def reset_counts() -> None:
    for c in COUNTS.values():
        c["calls"] = c["bytes"] = 0


def counts() -> dict:
    """A copy of the counters: {kind: {"calls": n, "bytes": n}}."""
    return {kind: dict(c) for kind, c in COUNTS.items()}


def _count(kind: str, x: torch.Tensor) -> None:
    COUNTS[kind]["calls"] += 1
    COUNTS[kind]["bytes"] += x.numel() * x.element_size()


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A contiguous real view of ``x`` for the backends (NCCL takes no
    complex tensors)."""
    x = x.contiguous()
    return torch.view_as_real(x) if x.is_complex() else x


def _ring(x: torch.Tensor, mesh, axis: str, step: int) -> torch.Tensor:
    """A shift around the ``axis`` ring: every rank sends ``x`` to index
    i - step and returns what index i + step sent."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x.clone()
    group = axis_group(mesh, axis)
    i = axis_index(mesh, axis)
    send = _wire(x)
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send,
                      dist.get_global_rank(group, (i - step) % n), group),
           dist.P2POp(dist.irecv, recv,
                      dist.get_global_rank(group, (i + step) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    _count("permute", send)
    return torch.view_as_complex(recv) if x.is_complex() else recv


def right_halo(local: torch.Tensor, halo: int, mesh,
               axis: str = TIME_AXIS) -> torch.Tensor:
    """Append the first ``halo`` samples of the right neighbour's shard:
    [..., T_local] -> [..., T_local + halo].  The last shard of the ring
    receives the FIRST shard's head (circular); callers zero it or rely on
    it lying past every valid peak."""
    if halo > local.shape[-1]:
        raise ValueError(f"halo {halo} exceeds the shard's {local.shape[-1]}")
    return torch.cat([local, _ring(local[..., :halo], mesh, axis, 1)], dim=-1)


def left_halo(local: torch.Tensor, halo: int, mesh,
              axis: str = TIME_AXIS) -> torch.Tensor:
    """Prepend the last ``halo`` samples of the left neighbour's shard:
    [..., T_local] -> [..., halo + T_local].  The first shard receives the
    LAST shard's tail (circular); callers zero it."""
    if halo > local.shape[-1]:
        raise ValueError(f"halo {halo} exceeds the shard's {local.shape[-1]}")
    return torch.cat([_ring(local[..., local.shape[-1] - halo:], mesh, axis,
                            -1), local], dim=-1)


def all_reduce(x: torch.Tensor, mesh, axis: str | None = TIME_AXIS,
               op=dist.ReduceOp.SUM) -> torch.Tensor:
    """``x`` reduced over the ``axis`` line (over the whole mesh with None);
    one call, returns a new tensor of x's shape and dtype."""
    group = mesh_group(mesh) if axis is None else axis_group(mesh, axis)
    buf = _wire(x).clone()
    dist.all_reduce(buf, op=op, group=group)
    _count("all_reduce", buf)
    return torch.view_as_complex(buf) if x.is_complex() else buf


def all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """The ``axis`` line's ``x`` concatenated along dim 0, in axis order."""
    send = _wire(x)
    parts = [torch.empty_like(send) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, send, group=axis_group(mesh, axis))
    _count("all_gather", send)
    out = torch.cat(parts, dim=0)
    return torch.view_as_complex(out) if x.is_complex() else out


def global_key_max(keys: torch.Tensor, mesh,
                   axis: str = TIME_AXIS) -> torch.Tensor:
    """The largest packed key along ``axis``: one all_reduce(MAX) of int64."""
    return all_reduce(keys, mesh, axis, op=dist.ReduceOp.MAX)


def global_argmax(power: torch.Tensor, mesh, axis: str = TIME_AXIS):
    """Distributed argmax over time shards.

    power: [..., T_local] >= 0 (halo-trimmed, so no window counts twice).
    Returns the global index [...] (int64) of the max across the sharded
    last axis, the FIRST occurrence on ties as the reference's argmax
    (src/signals/mod.rs:205-214): one all_reduce(MAX) of the keys
    (power bits << 32) | (0xFFFFFFFF - global index), where JAX makes a
    pmax and then a pmin."""
    keys = argmax_keys(power, axis_index(mesh, axis) * power.shape[-1])
    return key_lag(global_key_max(keys, mesh, axis))
