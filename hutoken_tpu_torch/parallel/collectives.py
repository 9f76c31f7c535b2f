"""The collectives of the data mesh, over a list of per-shard tensors.

The reference runs its shard ops under ``shard_map``, where ``all_gather``,
``psum``, ``pmax`` and ``axis_index`` name the ``data`` axis.  Here one
controller holds every shard, so a collective is a plain function of the
list: a replicated result is one tensor on the first shard's device,
which each shard's phase moves to its own device (a no-op when the
shards share a card).  With one shard they are identities and launch
nothing.  They stay in this one module so that a multi-host version can
put ``torch.distributed`` behind the same names.
"""

from __future__ import annotations

import torch


def all_gather(xs: list[torch.Tensor]) -> torch.Tensor:
    """Every shard's ``x`` stacked along a new first axis."""
    if len(xs) == 1:
        return xs[0].unsqueeze(0)
    dev = xs[0].device
    return torch.stack([x.to(dev) for x in xs])


def psum(xs: list[torch.Tensor]) -> torch.Tensor:
    """The sum over shards, in the shards' dtype (``torch.sum`` of int32
    would widen to int64)."""
    if len(xs) == 1:
        return xs[0]
    return all_gather(xs).sum(0, dtype=xs[0].dtype)


def pmax(xs: list[torch.Tensor]) -> torch.Tensor:
    """The elementwise maximum over shards."""
    if len(xs) == 1:
        return xs[0]
    return all_gather(xs).amax(0)


def axis_index(mesh) -> range:
    """The indices of the shards this controller drives: all of them."""
    return range(mesh.size)
