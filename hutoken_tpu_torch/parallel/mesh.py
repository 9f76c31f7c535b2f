"""The port's 1-D data mesh (counterpart of ``hutoken_tpu/parallel/mesh.py``).

One controller drives every shard, as JAX's one process drives every
local device: a sharded array is a list of per-shard tensors, shard
``s`` on ``mesh.devices[s]``.  Several shards may share a device, so
the multi-shard code runs on one card (or on the CPU, like JAX's
virtual 8-device CPU platform in the tests).  The multi-process branch
of the reference (``make_array_from_callback``) is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class DataMesh:
    """A 1-D ``data`` mesh: shard ``s`` lives on ``devices[s]``."""

    devices: tuple[torch.device, ...]

    @property
    def size(self) -> int:
        return len(self.devices)


def data_mesh(n_devices: int | None = None, device: str = "cuda") -> DataMesh:
    """A mesh of ``n_devices`` shards.

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
    length, each on its shard's device.  A length that is not a multiple
    of the mesh size is padded with -1 at the tail of the array, as the
    trainer pads its corpus (``hutoken_tpu/parallel/train.py:1747-1750``)."""
    t = torch.as_tensor(np.asarray(array))
    if t.dim() != 1:
        raise ValueError(f"shard_batch: expects a 1-D array, not shape {tuple(t.shape)}")
    pad = (-t.shape[0]) % mesh.size
    if pad:
        t = torch.cat([t, t.new_full((pad,), -1)])
    n = t.shape[0] // mesh.size
    return [t[s * n : (s + 1) * n].to(dev) for s, dev in enumerate(mesh.devices)]
