"""Segmented byte-level merge of the words of a byte chunk, in place:
the hand-written CUDA kernel ``csrc/seg_merge.cu`` and its plain
PyTorch twin.

The kernel replaces ``hutoken_tpu/ops/pallas_merge.py::_kernel_seg``;
the source file says how it is laid out for Hopper.  :func:`seg_merge`
launches it for CUDA tensors and runs :func:`seg_merge_plain` only for
CPU tensors: there is no fallback from one to the other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .build import build_library
from .fused_merge import MAX_WORD, merge_rounds


def build() -> str:
    """Compile the kernel (once per digest of its source and headers);
    returns the shared library's path."""
    return build_library("seg_merge")


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(build())
    p = ctypes.c_void_p
    lib.ht_seg_merge.restype = ctypes.c_int
    lib.ht_seg_merge.argtypes = [
        p, ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,  # pslots, cap_mask, probe_len, multi
        p, p, p, p, ctypes.c_int64,  # byte_seed, chunk, word_start, word_len, num_words
        p, p,  # out, stream
    ]
    return lib


def _check_inputs(tab, chunk, word_start, word_len) -> None:
    if chunk.dim() != 1 or chunk.dtype != torch.uint8:
        raise ValueError(f"chunk must be uint8 [N], got {chunk.dtype} {tuple(chunk.shape)}")
    for name, t in (("word_start", word_start), ("word_len", word_len)):
        if t.dtype != torch.int32 or t.dim() != 1:
            raise ValueError(f"{name} must be int32 [W], got {t.dtype} {tuple(t.shape)}")
    if word_start.shape != word_len.shape:
        raise ValueError("word_start and word_len differ in length")
    if tab.byte_seed is None:
        raise ValueError("the segmented merge needs a byte-level table (byte_seed)")
    if tab.wide:
        # as in the JAX engine, a vocabulary past 16 bits takes no raw path
        raise ValueError("the segmented merge takes the narrow packed table only")
    for t in (chunk, word_start, word_len):
        if t.device != tab.device:
            raise ValueError(f"input on {t.device}, tables on {tab.device}")


def seg_merge(tab, chunk: torch.Tensor, word_start: torch.Tensor,
              word_len: torch.Tensor) -> torch.Tensor:
    """Greedy merge of W words of a chunk, in place.

    ``chunk`` uint8 [N]; word w is ``chunk[word_start[w] :
    word_start[w] + word_len[w]]`` (int32, lengths 1..32, words
    disjoint; a word of length 0 is skipped).  Returns ids int32 [N]:
    each surviving token's id at the byte of its first byte, -1 at every
    other byte.

    A CUDA tensor launches the kernel on the current stream without
    synchronising (and adds one to ``seg_merge.launches``); a CPU tensor
    runs :func:`seg_merge_plain`.
    """
    _check_inputs(tab, chunk, word_start, word_len)
    if chunk.device.type == "cpu":
        return seg_merge_plain(tab, chunk, word_start, word_len)
    if chunk.device.type != "cuda":
        raise ValueError(f"unsupported device {chunk.device}")
    out = torch.full(chunk.shape, -1, dtype=torch.int32, device=chunk.device)
    W = word_start.shape[0]
    if W == 0:
        return out
    chunk = chunk.contiguous()
    word_start = word_start.contiguous()
    word_len = word_len.contiguous()
    with torch.cuda.device(chunk.device):
        stream = torch.cuda.current_stream(chunk.device).cuda_stream
        rc = _library().ht_seg_merge(
            tab.pslots.data_ptr(), tab.cap_mask, tab.probe_len, int(tab.minsuper is not None),
            tab.byte_seed.data_ptr(), chunk.data_ptr(), word_start.data_ptr(),
            word_len.data_ptr(), W, out.data_ptr(), stream,
        )
    if rc != 0:
        raise RuntimeError(f"seg_merge kernel launch failed: CUDA error {rc}")
    seg_merge.launches += 1
    return out


seg_merge.launches = 0


def seg_merge_plain(tab, chunk: torch.Tensor, word_start: torch.Tensor,
                    word_len: torch.Tensor) -> torch.Tensor:
    """The kernel in plain PyTorch: gather each word into a [W, 32] row,
    run the fused merge twin's rounds carrying each token's byte offset,
    scatter the survivors back.  Runs on any device; :func:`seg_merge`
    uses it for CPU tensors, and the kernel is held against it on the
    card."""
    N = chunk.shape[0]
    dev = chunk.device
    out = torch.full((N + 1,), -1, dtype=torch.int32, device=dev)
    if word_start.shape[0] == 0:
        return out[:N]
    col = torch.arange(MAX_WORD, device=dev)[None, :]
    first = word_start.to(torch.int64)[:, None]
    raw = chunk[(first + col).clamp(max=N - 1)]
    offs = col.expand(raw.shape[0], MAX_WORD)
    ids, n, offs = merge_rounds(tab, raw, word_len, offs)
    dest = torch.where(col < n.to(torch.int64)[:, None], first + offs, N)
    out.scatter_(0, dest.reshape(-1), ids.reshape(-1))
    return out[:N]
