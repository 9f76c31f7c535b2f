"""Sharded encode: the merge fixed point with the word axis split over
the data mesh (counterpart of ``hutoken_tpu/parallel/sharded.py``).

The padded word block's rows are cut into contiguous slices, one per
shard; each shard runs the same fixed point on its slice, on its own
device.  There is no cross-word state, so no collective is needed: the
only multi-device cost is placing the slices and the table replicas.
"""

from __future__ import annotations

import torch

from ..ops.id_merge import id_merge
from .mesh import DataMesh


def row_slices(rows: int, mesh: DataMesh) -> list[slice]:
    """This process's share of ``rows`` rows: ``mesh.size`` contiguous
    slices in global shard order, their lengths differing by at most
    one, of which it takes its own shards'.
    The reference requires the rows to divide over the mesh; this split
    does not."""
    bounds = [s * rows // mesh.size for s in range(mesh.size + 1)]
    return [slice(bounds[s], bounds[s + 1]) for s in mesh.local_shards]


def replicas(dev_tables, mesh: DataMesh) -> list:
    """``dev_tables`` on each local shard's device, one copy per distinct
    device (shards on one card share it)."""
    by_device = {}
    for d in mesh.devices:
        if d not in by_device:
            by_device[d] = dev_tables.to(d)
    return [by_device[d] for d in mesh.devices]


def sharded_merge_words(dev_tables, mesh: DataMesh, ids) -> list[torch.Tensor]:
    """Run the merge fixed point on a padded int32 ``[W, L]`` block (a
    tensor or an array, PAD = -1, L <= 128) with its rows split over
    ``mesh``'s shards and the tables (``tables.DeviceTables``) replicated
    per device: the id merge kernel's padded layout on a card, its twin
    ``merge_fixed_point`` on the CPU.  Returns the merged slices of this
    process's shards, each on its shard's device, as every sharded array
    of the port is a list.
    On a mesh that spans processes every process passes the whole block
    and merges its own shards' rows."""
    if not isinstance(mesh, DataMesh):
        raise TypeError(f"mesh must be a DataMesh (data_mesh()), not {type(mesh).__name__}")
    ids = torch.as_tensor(ids)
    if ids.dim() != 2:
        raise ValueError(f"sharded_merge_words: expects a [W, L] block, not shape {tuple(ids.shape)}")
    return [
        id_merge(tab, ids[rows].to(tab.device, torch.int32), False, padded=True)
        for rows, tab in zip(row_slices(ids.shape[0], mesh), replicas(dev_tables, mesh))
    ]
