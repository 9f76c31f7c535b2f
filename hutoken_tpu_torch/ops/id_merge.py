"""The greedy merge fixed point of id rows and of words of up to 128
bytes: the hand-written CUDA kernel ``csrc/id_merge.cu`` and its plain
PyTorch twin.

The kernel replaces the XLA program of
``hutoken_tpu/ops/merge.py::_merge_fixed_point`` with the packing or the
padding around it (``_merge_ids_packed``, ``_merge_bytes_packed``,
``merge_words``); the source file says how it is laid out for Hopper.
The engine sends it every char-mode id block, byte words of 33-128
bytes, and the sharded merge's rows.

Each entry launches the kernel for CUDA tensors, adding one to
``id_merge.launches`` (narrow table) or ``id_merge.wide_launches`` (wide
table), and runs the twin, ``ops/merge.py``'s ``merge_fixed_point``
with ``compact_output``, only for CPU tensors: there is no fallback
from one to the other.

The library is built with ``nvcc`` at first use into ``_build/`` (see
``ops/build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build_library
from .merge import (
    merge_fixed_point,
    merge_words_from_bytes_packed,
    merge_words_packed,
)

MAX_LEN = 128  # the longest row: a warp of 32 lanes, 4 ids a lane
WARPS_PER_BLOCK = 8  # csrc/id_merge.cu kWarpsPerBlock


def build() -> str:
    """Compile the kernel (once per digest of its source and headers);
    returns the shared library's path."""
    return build_library("id_merge")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    i32 = ctypes.c_int32
    args = [
        p, ctypes.c_int64, i32,  # slots, cap_mask, probe_len
        p, p, p, p, ctypes.c_int64, i32,  # ids, byte_seed, raw, lens, num_words, width
        i32, i32, p, p, p,  # u16_out, padded, out, scan, stream
    ]
    for fn in (lib.ht_id_merge, lib.ht_id_merge_wide):
        fn.restype = ctypes.c_int
        fn.argtypes = args
    return lib


def words_per_block(width: int) -> int:
    """Rows a block of the kernel takes: a tile of 8 lanes a row up to 32
    ids, a warp a row past that."""
    lanes = 8 if width <= 32 else 32
    return WARPS_PER_BLOCK * (32 // lanes)


def _check_block(tab, x: torch.Tensor, what: str) -> None:
    if x.dim() != 2:
        raise ValueError(f"{what} must be [W, L], got shape {tuple(x.shape)}")
    if x.shape[1] > MAX_LEN:
        raise ValueError(f"rows are at most {MAX_LEN} long, got L={x.shape[1]}")
    if x.device != tab.device:
        raise ValueError(f"{what} on {x.device}, tables on {tab.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def id_merge(tab, ids: torch.Tensor, u16_out: bool, padded: bool = False) -> torch.Tensor:
    """Greedy merge of an int32 ``[W, L]`` id block (PAD = -1, L <= 128).

    Returns the packed layout (the counterpart of ``merge_words_packed``):
    a 1-D tensor of ``W + W * L`` entries, int16 holding uint16 bit
    patterns when ``u16_out``, else int32, the W per-row counts of ids
    that are not PAD, then those ids row-major.  Only that prefix,
    ``W + sum(counts)`` entries, is defined on the card.  With ``padded``
    it returns int32 ``[W, L]`` instead, each row's merged ids in place
    and PAD after them (the counterpart of ``merge_words``); ``u16_out``
    is then ignored.

    A CUDA tensor launches the kernel on the current stream without
    synchronising; a CPU tensor runs the twin."""
    _check_block(tab, ids, "ids")
    if ids.dtype != torch.int32:
        raise ValueError(f"ids must be int32, got {ids.dtype}")
    if ids.device.type == "cpu":
        return merge_fixed_point(tab, ids) if padded else merge_words_packed(tab, ids, u16_out)
    return _launch(tab, ids.contiguous(), None, None, u16_out and not padded, padded)


def id_merge_bytes(tab, raw: torch.Tensor, lens: torch.Tensor, u16_out: bool) -> torch.Tensor:
    """Byte-mode merge of W words of at most 128 bytes, in the packed
    layout (the counterpart of ``merge_words_from_bytes_packed``):
    ``raw`` uint8 ``[W, L]``, ``lens`` int32 ``[W]``, each byte seeded
    through ``tab.byte_seed``.  Launches as :func:`id_merge` does."""
    _check_block(tab, raw, "raw")
    if raw.dtype != torch.uint8:
        raise ValueError(f"raw must be uint8, got {raw.dtype}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (raw.shape[0],) or lens.device != raw.device:
        raise ValueError(f"lens must be int32 [{raw.shape[0]}] on {raw.device}")
    if tab.byte_seed is None:
        raise ValueError("a byte block needs a byte-level table (byte_seed)")
    if raw.device.type == "cpu":
        return merge_words_from_bytes_packed(tab, raw, lens, u16_out)
    return _launch(tab, None, raw.contiguous(), lens.contiguous(), u16_out, False)


def _launch(tab, ids, raw, lens, u16_out: bool, padded: bool) -> torch.Tensor:
    src = ids if ids is not None else raw
    W, L = src.shape
    dev = src.device
    if padded:
        out = torch.empty((W, L), dtype=torch.int32, device=dev)
    else:
        out = torch.empty(W + W * L, dtype=torch.int16 if u16_out else torch.int32, device=dev)
    if W == 0:
        return out
    # the look-back's ticket, then one status word per block
    scan = torch.zeros(1 + -(-W // words_per_block(L)), dtype=torch.int64, device=dev)

    def ptr(t):
        return None if t is None else t.data_ptr()

    lib = _library()
    fn = lib.ht_id_merge_wide if tab.wide else lib.ht_id_merge
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(
            (tab.slots if tab.wide else tab.pslots).data_ptr(), tab.cap_mask, tab.probe_len,
            ptr(ids), ptr(tab.byte_seed if raw is not None else None), ptr(raw), ptr(lens),
            W, L, int(u16_out), int(padded), out.data_ptr(), scan.data_ptr(), stream,
        )
    if rc != 0:
        variant = "wide " if tab.wide else ""
        raise RuntimeError(f"id_merge {variant}kernel launch failed: CUDA error {rc}")
    if tab.wide:
        id_merge.wide_launches += 1
    else:
        id_merge.launches += 1
    return out


id_merge.launches = 0
id_merge.wide_launches = 0
