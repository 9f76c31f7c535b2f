"""Multi-process runtime setup (counterpart of ``hutoken_tpu/parallel/multihost.py``).

Every process runs the same program; ``initialize_distributed`` joins
them in one ``torch.distributed`` group and ``global_data_mesh`` gives
the mesh over every shard of every process.  The trainers
(``parallel/train.py``) then combine the shards through
``collectives.py``, which crosses processes on such a mesh.  Encode
needs no communication: each process encodes its own texts on a
process-local mesh (``data_mesh``), and ``TorchTokenizer`` refuses a
mesh with shards on other processes.
"""

from __future__ import annotations

import os
from typing import Optional

import torch

from .mesh import DataMesh, data_mesh


def initialize_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: Optional[str] = None,
) -> None:
    """Join the process group (a no-op if this process already joined).

    ``coordinator_address`` is ``"host:port"`` of process 0's rendezvous,
    ``num_processes`` the world size and ``process_id`` this process's
    rank; left as None, the three come from ``MASTER_ADDR`` /
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK`` (``init_method="env://"``,
    as ``torchrun`` sets them).  ``backend`` defaults to NCCL when CUDA is
    available (one process per card: NCCL refuses two ranks on one GPU)
    and gloo otherwise; pass ``backend="gloo"`` for CPU shards, or for
    several processes sharing a card.
    """
    import torch.distributed as dist

    if dist.is_initialized():
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    init = "env://" if coordinator_address is None else f"tcp://{coordinator_address}"
    kw = {}
    if num_processes is not None:
        kw["world_size"] = num_processes
    if process_id is not None:
        kw["rank"] = process_id
    dist.init_process_group(backend=backend, init_method=init, **kw)


def global_data_mesh(n_local: Optional[int] = None, device: str = "cuda") -> DataMesh:
    """The 1-D ``data`` mesh over every shard of every process: this
    process drives ``n_local`` of them, and process ``p`` holds the
    global shards ``p * n_local`` onwards.

    On the card: with ``LOCAL_RANK`` set (one rank per card, as
    ``torchrun`` starts them), the shards sit on card ``LOCAL_RANK``,
    one by default; without it they span every visible card, one per
    card by default.  Torch has no virtual CPU devices, so
    ``device="cpu"`` takes the count of local CPU shards as
    ``data_mesh(n, device="cpu")`` does (default 1).  Every process must
    ask for as many shards.  Outside a process group it is
    ``data_mesh(n_local, device)``.
    """
    import torch.distributed as dist

    local = data_mesh(n_local, device)
    if device == "cuda":
        if "LOCAL_RANK" in os.environ:
            card = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
            local = DataMesh((card,) * (1 if n_local is None else n_local))
        # NCCL runs on the current card
        torch.cuda.set_device(local.devices[0])
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return local
    counts = [None] * dist.get_world_size()
    dist.all_gather_object(counts, len(local.devices))
    if len(set(counts)) != 1:
        raise ValueError(f"global_data_mesh: every process must drive as many shards, not {counts}")
    return DataMesh(local.devices, dist.get_rank(), dist.get_world_size())
