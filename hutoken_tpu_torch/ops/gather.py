"""Table gathers on int32 tables: the hand-written CUDA kernels of
``csrc/gather.cu`` and their plain PyTorch twins.

The kernels replace the Pallas gather probes of the TPU's profiling
scripts (``scripts/profile_pallas_gather.py`` ``k_take`` / ``k_taa``,
``scripts/profile_pallas_gather2.py`` ``k_gather2``,
``scripts/profile_gather3.py`` ``kernel`` / ``kernel0``); the source file
says how each is laid out for Hopper.  ``python -m
hutoken_tpu_torch.profile_gather`` runs them at the scripts' shapes.

Each entry point launches its kernel for CUDA tensors and runs its twin
only for CPU tensors: there is no fallback from one to the other.
Indices must be in range, as the TPU kernels assume; the kernels do not
check them.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build_library

LANES = 128  # the TPU's lane width, which fixes the two-level layout


def build() -> str:
    """Compile the kernels (once per digest of their source); returns the
    shared library's path."""
    return build_library("gather")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.ht_gather_smem_limit.restype = ctypes.c_int
    lib.ht_gather_smem_limit.argtypes = []
    for name, args in (
        ("ht_gather_1d", [p, i64, p, i64, p, ctypes.c_int, p]),
        ("ht_gather_two_level", [p, p, i64, p, p]),
        ("ht_gather_rows", [p, i64, i64, p, i64, p, p]),
        ("ht_gather_cols", [p, i64, p, i64, p, p]),
    ):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


@functools.lru_cache(maxsize=None)
def _smem_limit(device_index: int) -> int:
    """Bytes of shared memory a block may opt in to on that card."""
    with torch.cuda.device(device_index):
        return _library().ht_gather_smem_limit()


def _check(name: str, *pairs) -> torch.device:
    """All tensors int32, on one device; returns it."""
    dev = pairs[0][1].device
    for what, t in pairs:
        if t.dtype != torch.int32:
            raise ValueError(f"{name}: {what} must be int32, got {t.dtype}")
        if t.device != dev:
            raise ValueError(f"{name}: {what} on {t.device}, expected {dev}")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {dev}")
    return dev


def _launch(name: str, fn, dev: torch.device, *args) -> None:
    with torch.cuda.device(dev):
        rc = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {rc}")


def gather_1d(table: torch.Tensor, idx: torch.Tensor, smem: bool) -> torch.Tensor:
    """``table[idx]`` for an int32 table ``[C]`` and int32 indices of any
    shape.  ``smem=False`` reads the table through L2 (the counterpart of
    ``k_take``); ``smem=True`` stages it in shared memory first (the
    counterpart of ``k_taa``) and raises if ``C`` does not fit.

    A CUDA tensor launches the kernel on the current stream without
    synchronising and adds one to ``gather_1d.launches_by_mode["smem" |
    "l2"]``; a CPU tensor runs :func:`gather_1d_plain`.
    """
    dev = _check("gather_1d", ("table", table), ("idx", idx))
    if table.dim() != 1:
        raise ValueError(f"gather_1d: table must be 1-D, got {tuple(table.shape)}")
    if dev.type == "cpu":
        return gather_1d_plain(table, idx)
    if smem:
        limit = _smem_limit(dev.index if dev.index is not None else torch.cuda.current_device())
        if table.numel() * 4 > limit:
            raise ValueError(
                f"gather_1d: a table of {table.numel()} int32 does not fit the "
                f"{limit} bytes of shared memory a block may use"
            )
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0 or table.numel() == 0:
        return out
    table, idx = table.contiguous(), idx.contiguous()
    _launch("gather_1d", _library().ht_gather_1d, dev, table.data_ptr(), table.numel(),
            idx.data_ptr(), idx.numel(), out.data_ptr(), int(smem))
    gather_1d.launches_by_mode["smem" if smem else "l2"] += 1
    return out


gather_1d.launches_by_mode = {"l2": 0, "smem": 0}


def gather_1d_plain(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_1d`: plain indexing."""
    return table[idx.to(torch.int64)]


def gather_two_level(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``k_gather2``'s composed gather on a ``[C/128, 128]`` table and
    ``[M, 128]`` indices: with ``rows = idx >> 7`` and ``lanes = idx &
    127``, ``out[n, l] = table2d[rows[n, lanes[n, l]], lanes[n, l]]``.
    This is NOT ``table2d.reshape(-1)[idx]`` (the script checks both).

    CUDA: the kernel, counted in ``gather_two_level.launches``; CPU:
    :func:`gather_two_level_plain`.
    """
    dev = _check("gather_two_level", ("table2d", table2d), ("idx", idx))
    if table2d.dim() != 2 or idx.dim() != 2 or table2d.shape[1] != LANES or idx.shape[1] != LANES:
        raise ValueError(
            f"gather_two_level: table2d [R, {LANES}] and idx [M, {LANES}], got "
            f"{tuple(table2d.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_two_level_plain(table2d, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    table2d, idx = table2d.contiguous(), idx.contiguous()
    _launch("gather_two_level", _library().ht_gather_two_level, dev,
            table2d.data_ptr(), idx.data_ptr(), idx.shape[0], out.data_ptr())
    gather_two_level.launches += 1
    return out


gather_two_level.launches = 0


def gather_two_level_plain(table2d: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_two_level`: the script's two
    ``take_along_axis`` steps as two ``torch.gather``s."""
    idx = idx.to(torch.int64)
    g = torch.gather(table2d, 0, idx >> 7)  # g[n, j] = t[rows[n, j], j]
    return torch.gather(g, 1, idx & (LANES - 1))


def gather_rows(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[w, j] = R[w, idx[w, j]]`` for ``R`` ``[W, C2]`` and ``idx``
    ``[W, L]`` (``kernel`` of ``profile_gather3.py``).

    CUDA: the kernel, counted in ``gather_rows.launches``; CPU:
    :func:`gather_rows_plain`.
    """
    dev = _check("gather_rows", ("R", R), ("idx", idx))
    if R.dim() != 2 or idx.dim() != 2 or R.shape[0] != idx.shape[0]:
        raise ValueError(
            f"gather_rows: R [W, C2] and idx [W, L], got {tuple(R.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_rows_plain(R, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    R, idx = R.contiguous(), idx.contiguous()
    _launch("gather_rows", _library().ht_gather_rows, dev, R.data_ptr(), R.shape[0],
            R.shape[1], idx.data_ptr(), idx.shape[1], out.data_ptr())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def gather_rows_plain(R: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_rows`."""
    return torch.gather(R, 1, idx.to(torch.int64))


def gather_cols(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``out[n, l] = tbl[idx[n, l], l]`` for ``tbl`` ``[C, K]`` and
    ``idx`` ``[M, K]`` (``kernel0`` of ``profile_gather3.py``, K = 128).

    CUDA: the kernel, counted in ``gather_cols.launches``; CPU:
    :func:`gather_cols_plain`.
    """
    dev = _check("gather_cols", ("tbl", tbl), ("idx", idx))
    if tbl.dim() != 2 or idx.dim() != 2 or tbl.shape[1] != idx.shape[1]:
        raise ValueError(
            f"gather_cols: tbl [C, K] and idx [M, K], got {tuple(tbl.shape)} and {tuple(idx.shape)}"
        )
    if dev.type == "cpu":
        return gather_cols_plain(tbl, idx)
    out = torch.empty(idx.shape, dtype=torch.int32, device=dev)
    if idx.numel() == 0:
        return out
    tbl, idx = tbl.contiguous(), idx.contiguous()
    _launch("gather_cols", _library().ht_gather_cols, dev, tbl.data_ptr(), tbl.shape[1],
            idx.data_ptr(), idx.shape[0], out.data_ptr())
    gather_cols.launches += 1
    return out


gather_cols.launches = 0


def gather_cols_plain(tbl: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The twin of :func:`gather_cols`."""
    return torch.gather(tbl, 0, idx.to(torch.int64))


def reset_launches() -> None:
    """Set every gather kernel's launch count to 0."""
    gather_two_level.launches = gather_rows.launches = gather_cols.launches = 0
    gather_1d.launches_by_mode.update(l2=0, smem=0)
