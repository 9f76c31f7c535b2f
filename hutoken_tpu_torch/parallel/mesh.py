"""The port's 1-D data mesh (counterpart of ``hutoken_tpu/parallel/mesh.py``).

A sharded array is a list of this process's per-shard tensors, local
shard ``i`` on ``mesh.devices[i]``.  Several shards may share a device,
so the multi-shard code runs on one card (or on the CPU, like JAX's
virtual 8-device CPU platform in the tests).

A mesh may span processes (``multihost.global_data_mesh``): every
process drives the same number of shards, contiguous in the global
order as JAX's device order is, so process ``p`` holds the global
shards ``p * L .. p * L + L - 1`` of ``L * process_count``.  The
collectives (``collectives.py``) then reach the other processes through
``torch.distributed``.  ``data_mesh`` always gives a process-local mesh,
with or without a process group.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: this process's shards live on ``devices``,
    and ``process_count`` processes hold as many each."""

    devices: tuple[torch.device, ...]
    process_index: int = 0
    process_count: int = 1

    @property
    def size(self) -> int:
        """The global shard count."""
        return len(self.devices) * self.process_count

    @property
    def local_shards(self) -> range:
        """The global indices of the shards this process drives."""
        first = self.process_index * len(self.devices)
        return range(first, first + len(self.devices))


def data_mesh(n_devices: int | None = None, device: str = "cuda") -> DataMesh:
    """A process-local mesh of ``n_devices`` shards.

    ``device="cuda"`` (the default) spans every visible CUDA device when
    ``n_devices`` is None; more shards than cards are spread over the
    cards in contiguous groups.  Without CUDA it raises: it never falls
    back to the CPU.  ``device="cpu"`` gives ``n_devices`` (default 1)
    logical shards on the CPU.
    """
    if device == "cpu":
        n = 1 if n_devices is None else n_devices
        devices = (torch.device("cpu"),) * n
    elif device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "data_mesh: no CUDA device (torch.cuda.is_available() is False); "
                'pass device="cpu" for shards on the CPU'
            )
        cards = torch.cuda.device_count()
        n = cards if n_devices is None else n_devices
        devices = tuple(torch.device("cuda", s * cards // max(n, 1)) for s in range(n))
    else:
        raise ValueError(f'data_mesh: device must be "cuda" or "cpu", not {device!r}')
    if n < 1:
        raise ValueError(f"data_mesh: needs at least one shard, not {n}")
    return DataMesh(devices)


def shard_batch(mesh: DataMesh, array) -> list[torch.Tensor]:
    """Split a 1-D int array into ``mesh.size`` contiguous slices of equal
    length and return this process's, each on its shard's device.  A
    length that is not a multiple of the mesh size is padded with -1 at
    the tail of the array, as the trainer pads its corpus
    (``hutoken_tpu/parallel/train.py:1747-1750``).  On a mesh that spans
    processes every process passes the same full array, as in the
    reference's multi-process branch."""
    t = torch.as_tensor(np.asarray(array))
    if t.dim() != 1:
        raise ValueError(f"shard_batch: expects a 1-D array, not shape {tuple(t.shape)}")
    pad = (-t.shape[0]) % mesh.size
    if pad:
        t = torch.cat([t, t.new_full((pad,), -1)])
    n = t.shape[0] // mesh.size
    return [t[s * n : (s + 1) * n].to(dev) for s, dev in zip(mesh.local_shards, mesh.devices)]
