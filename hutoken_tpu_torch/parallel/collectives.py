"""The collectives of the data mesh, over this process's list of per-shard
tensors.

The reference runs its shard ops under ``shard_map``, where ``all_gather``,
``psum``, ``pmax`` and ``axis_index`` name the ``data`` axis.  Here a
collective is a plain function of the list: a replicated result is one
tensor on the first local shard's device, which each shard's phase moves
to its own device (a no-op when the shards share a card).

On a mesh that spans processes (``mesh.process_count > 1``) the local
result is combined with the other processes' through
``torch.distributed``'s default group, whose ranks are the mesh's
processes in order: ``all_gather`` stacks the local shards and gathers
the per-process stacks, ``psum`` / ``pmax`` reduce the local partials
across processes.  The transport follows the backend: NCCL moves the
device tensors, gloo host copies of them.  The results equal those of
one process holding every shard, bit for bit (the trainers reduce only
integers).  Without ``mesh``, or with one process, nothing leaves the
process, and with one shard nothing is launched.
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def _spans(mesh) -> bool:
    return mesh is not None and mesh.process_count > 1


def _wire(x: torch.Tensor) -> torch.Tensor:
    """A private copy of ``x`` as the backend moves it: on the card for
    NCCL, on the host for gloo; bool as uint8."""
    dev = x.device if dist.get_backend() == "nccl" else torch.device("cpu")
    w = x.to(dev, dtype=torch.uint8 if x.dtype == torch.bool else x.dtype, copy=True)
    return w.contiguous()


def _gather_processes(x: torch.Tensor) -> torch.Tensor:
    """Every process's ``x`` (same shape on each) concatenated along the
    first axis in rank order."""
    w = _wire(x)
    parts = [torch.empty_like(w) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, w)
    return torch.cat(parts).to(x.device, dtype=x.dtype)


def _reduce_processes(x: torch.Tensor, op) -> torch.Tensor:
    w = _wire(x)
    dist.all_reduce(w, op=op)
    return w.to(x.device, dtype=x.dtype)


def all_gather(xs: list[torch.Tensor], mesh=None) -> torch.Tensor:
    """Every shard's ``x`` stacked along a new first axis, in global
    shard order."""
    if len(xs) == 1:
        local = xs[0].unsqueeze(0)
    else:
        dev = xs[0].device
        local = torch.stack([x.to(dev) for x in xs])
    return _gather_processes(local) if _spans(mesh) else local


def all_gather_ragged(xs: list[torch.Tensor], mesh=None) -> torch.Tensor:
    """Every shard's 1-D ``x`` concatenated in global shard order, the
    lengths free to differ: across processes the lengths go first, then
    the tensors padded to the longest."""
    dev = xs[0].device
    local = torch.cat([x.to(dev) for x in xs])
    if not _spans(mesh):
        return local
    sizes = _gather_processes(torch.tensor([local.shape[0]], device=dev)).tolist()
    top = max(sizes)
    padded = torch.cat([local, local.new_zeros(top - local.shape[0])])
    got = _gather_processes(padded.unsqueeze(0))
    return torch.cat([got[p, :n] for p, n in enumerate(sizes)])


def psum(xs: list[torch.Tensor], mesh=None) -> torch.Tensor:
    """The sum over shards, in the shards' dtype (``torch.sum`` of int32
    would widen to int64)."""
    local = xs[0] if len(xs) == 1 else all_gather(xs).sum(0, dtype=xs[0].dtype)
    return _reduce_processes(local, dist.ReduceOp.SUM) if _spans(mesh) else local


def pmax(xs: list[torch.Tensor], mesh=None) -> torch.Tensor:
    """The elementwise maximum over shards."""
    local = xs[0] if len(xs) == 1 else all_gather(xs).amax(0)
    return _reduce_processes(local, dist.ReduceOp.MAX) if _spans(mesh) else local


def axis_index(mesh) -> range:
    """The global indices of the shards this process drives."""
    return mesh.local_shards
