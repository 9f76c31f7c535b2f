"""Fused byte-level merge for words of up to 32 bytes: the hand-written
CUDA kernel ``csrc/fused_merge.cu`` and its plain PyTorch twin.

The kernel replaces ``hutoken_tpu/ops/pallas_merge.py::_kernel`` /
``_kernel_body``; the source file says how it is laid out for Hopper.
Its wide variant, the same kernel on the wide pair table, serves
vocabularies whose ids or ranks pass 16 bits, where the JAX package runs
the R-matrix program (``hutoken_tpu/ops/rmatrix.py``).
:func:`fused_merge` launches the variant of the table's layout for CUDA
tensors and runs the twin only for CPU tensors: there is no fallback
from one to the other.

The library is built with ``nvcc`` at first use into ``_build/`` (see
``ops/build.py``) and bound with ``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build_library
from .merge import INF_RANK, compact_output, probe_pairs

MAX_WORD = 32  # the warp width: one lane per byte


def build() -> str:
    """Compile the kernel (once per digest of its source and headers);
    returns the shared library's path."""
    return build_library("fused_merge")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    lib.ht_fused_merge.restype = ctypes.c_int
    lib.ht_fused_merge.argtypes = [
        p, p, ctypes.c_int64, ctypes.c_int32,  # pkey, pval, cap_mask, probe_len
        p, p, ctypes.c_int32,  # byte_seed, minsuper, minsuper_len
        p, p, ctypes.c_int64, ctypes.c_int32,  # raw, lens, num_words, width
        p, p, p,  # out, counts, stream
    ]
    lib.ht_fused_merge_wide.restype = ctypes.c_int
    lib.ht_fused_merge_wide.argtypes = [
        p, ctypes.c_int64, ctypes.c_int32,  # slots, cap_mask, probe_len
        *lib.ht_fused_merge.argtypes[4:],
    ]
    return lib


def _check_inputs(tab, raw: torch.Tensor, lens: torch.Tensor) -> None:
    if raw.dim() != 2 or raw.dtype != torch.uint8:
        raise ValueError(f"raw must be uint8 [W, L], got {raw.dtype} {tuple(raw.shape)}")
    if raw.shape[1] > MAX_WORD:
        raise ValueError(f"words are at most {MAX_WORD} bytes, got L={raw.shape[1]}")
    if lens.dtype != torch.int32 or tuple(lens.shape) != (raw.shape[0],):
        raise ValueError(f"lens must be int32 [{raw.shape[0]}]")
    if tab.byte_seed is None:
        raise ValueError("the fused merge needs a byte-level table (byte_seed)")
    if raw.device != tab.device or lens.device != tab.device:
        raise ValueError(f"inputs on {raw.device}/{lens.device}, tables on {tab.device}")


def fused_merge(tab, raw: torch.Tensor, lens: torch.Tensor):
    """Greedy merge of W words of at most 32 bytes.

    ``raw`` uint8 [W, L <= 32] (row w holds word w's bytes), ``lens``
    int32 [W].  Returns ``(ids int32 [W, L], counts int32 [W])``: each
    word's tokens left-compacted, -1 after them.

    A CUDA tensor launches the kernel on the current stream without
    synchronising and adds one to ``fused_merge.launches``, or, on a
    wide table, launches the wide variant and adds one to
    ``fused_merge.wide_launches``; a CPU tensor runs
    :func:`fused_merge_plain`.
    """
    _check_inputs(tab, raw, lens)
    if raw.device.type == "cpu":
        return fused_merge_plain(tab, raw, lens)
    if raw.device.type != "cuda":
        raise ValueError(f"unsupported device {raw.device}")
    W, L = raw.shape
    out = torch.empty((W, L), dtype=torch.int32, device=raw.device)
    counts = torch.empty(W, dtype=torch.int32, device=raw.device)
    if W == 0:
        return out, counts
    raw = raw.contiguous()
    lens = lens.contiguous()
    ms = tab.minsuper
    lib = _library()
    with torch.cuda.device(raw.device):
        stream = torch.cuda.current_stream(raw.device).cuda_stream
        rest = (
            tab.cap_mask, tab.probe_len, tab.byte_seed.data_ptr(),
            ms.data_ptr() if ms is not None else None,
            ms.numel() if ms is not None else 0,
            raw.data_ptr(), lens.data_ptr(), W, L,
            out.data_ptr(), counts.data_ptr(), stream,
        )
        if tab.wide:
            rc = lib.ht_fused_merge_wide(tab.slots.data_ptr(), *rest)
        else:
            rc = lib.ht_fused_merge(tab.pkey.data_ptr(), tab.pval.data_ptr(), *rest)
    if rc != 0:
        variant = "wide " if tab.wide else ""
        raise RuntimeError(f"fused_merge {variant}kernel launch failed: CUDA error {rc}")
    if tab.wide:
        fused_merge.wide_launches += 1
    else:
        fused_merge.launches += 1
    return out, counts


fused_merge.launches = 0
fused_merge.wide_launches = 0


def fused_merge_plain(tab, raw: torch.Tensor, lens: torch.Tensor):
    """The kernel's rounds in plain PyTorch on [W, L] tensors: same
    probe (of the table's layout), same minimum, same multi-merge guard,
    same per-round compaction.  Runs on any device; :func:`fused_merge` uses it for CPU
    tensors, and the kernel is held against it on the card."""
    ids, n, _tags = merge_rounds(tab, raw, lens)
    return ids, n


def merge_rounds(tab, raw: torch.Tensor, lens: torch.Tensor, tags=None):
    """``fused_merge_plain``'s rounds; ``tags`` (int [W, L] or None)
    travel with their ids through every compaction, as the segmented
    kernel carries byte offsets.  Returns ``(ids int32 [W, L], counts
    int32 [W], tags)``."""
    W, L = raw.shape
    dev = raw.device
    col = torch.arange(L, device=dev)[None, :]
    rows = torch.arange(W, device=dev)[:, None].expand(W, L)
    n = lens.to(torch.int64).clamp(0, L)[:, None]
    ids = torch.where(col < n, tab.byte_seed[raw.to(torch.int64)], -1)
    ms = tab.minsuper
    while True:
        # PAD (-1) right neighbours make the probe report INF_RANK
        right = torch.cat([ids[:, 1:], torch.full_like(ids[:, :1], -1)], dim=1)
        rank, merged = probe_pairs(tab, ids, right)
        rank = rank.to(torch.int64)
        finite = rank < INF_RANK
        cand = torch.where(finite, rank * MAX_WORD + col, INF_RANK)
        best = cand.min(dim=1, keepdim=True).values
        if not bool((best < INF_RANK).any()):
            break
        applied = (col == best % MAX_WORD) & (best < INF_RANK)
        if ms is not None:
            in_ms = finite & (rank < ms.numel())
            msup = torch.where(in_ms, ms[rank.clamp(0, ms.numel() - 1)].to(torch.int64), 0)
            rprev = torch.cat([torch.full_like(rank[:, :1], INF_RANK), rank[:, :-1]], dim=1)
            msl = torch.cat([torch.zeros_like(msup[:, :1]), msup[:, :-1]], dim=1)
            rnext = torch.cat([rank[:, 1:], torch.full_like(rank[:, :1], INF_RANK)], dim=1)
            msr = torch.cat([msup[:, 1:], torch.zeros_like(msup[:, :1])], dim=1)
            safe_l = (col == 0) | ((rprev < INF_RANK) & (rprev > rank) & (msl > rank))
            safe_r = (col + 2 >= n) | ((rnext < INF_RANK) & (rnext > rank) & (msr > rank))
            applied = applied | (finite & safe_l & safe_r)
        consumed = torch.cat([torch.zeros_like(applied[:, :1]), applied[:, :-1]], dim=1)
        keep = (col < n) & ~consumed
        ids = torch.where(applied, merged, ids)
        # left-compact the survivors; dropped lanes land in a spare column
        dest = torch.where(keep, torch.cumsum(keep, dim=1) - 1, L)
        nxt = torch.full((W, L + 1), -1, dtype=ids.dtype, device=dev)
        nxt[rows, dest] = ids
        ids = nxt[:, :L]
        if tags is not None:
            nxt_tags = torch.full((W, L + 1), -1, dtype=tags.dtype, device=dev)
            nxt_tags[rows, dest] = tags
            tags = nxt_tags[:, :L]
        n = keep.sum(dim=1, keepdim=True)
    return ids.to(torch.int32), n.squeeze(1).to(torch.int32), tags


def merge_words_from_bytes_fused(
    tab, raw: torch.Tensor, lens: torch.Tensor, u16_out: bool
) -> torch.Tensor:
    """Byte-mode merge of words of <= 32 bytes in the packed layout of
    :func:`~hutoken_tpu_torch.ops.merge.compact_output` (the counterpart
    of ``merge_words_from_bytes_pallas``)."""
    ids, _counts = fused_merge(tab, raw, lens)
    return compact_output(ids, u16_out)
