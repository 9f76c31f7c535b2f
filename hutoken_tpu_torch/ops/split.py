"""The cache-cold raw chunk path in PyTorch (port of
``hutoken_tpu/ops/split.py``).

One program per byte chunk of documents, run eagerly on the chunk's
tensors, takes the place of the word pipeline's host split, intern,
pack and assemble:

1. token-start mask (the native splitter's 3-byte-window rule, see the
   reference module docstring) with context resets at every segment
   start, so no word spans two documents;
2. word geometry: the word starts (``torch.nonzero``, the one host
   sync per chunk) and their differences;
3. words of at most 32 bytes merge in place with the ``seg_merge``
   kernel (``ops/seg_merge.py``); longer words become flag records
   ``(byte_start, byte_len, token_insert_pos)`` for the exact host path;
4. the surviving ids are compacted in byte order (``cumsum`` + scatter),
   with per-segment cumulative token counts.

The host keeps chunk preparation, safe-cut selection, the alphabet
precheck and the splice of flagged words.

Left out from the reference, with the reason: the escape-coded,
bit-packed and sparse stream modes, the mode-overlaid blob and the
speculative prefix fetch (they save round trips on a tunneled TPU link;
here one non-blocking copy brings the meta block and the plain u16/i32
stream back together), the 96/128 windowed layout and the payload sort
(they keep XLA away from gathers and sorts; the kernel takes the word
list straight from the start mask), and the partial-table divergence
probe (the port's pair table is never partial).

``hutoken_tpu/ops/split.py`` imports JAX when it loads (its jit
decorator), so the numpy helpers below are JAX-free copies; tests hold
each equal to the original.
"""

from __future__ import annotations

import numpy as np
import torch

from .seg_merge import MAX_WORD, seg_merge

# Hungarian accent continuation bytes per lead page (low 6 bits), same
# sets as native/src/hutoken_host.cpp HuAccentTables / src/parser.c:102-129.
_ACC_C3 = (0x81, 0x89, 0x8D, 0x93, 0x96, 0x9A, 0x9C,
           0xA1, 0xA9, 0xAD, 0xB3, 0xB6, 0xBA, 0xBC)
_ACC_C5 = (0x90, 0x91, 0xB0, 0xB1)


def _acc_mask_u64(acc: tuple) -> tuple[int, int]:
    lo = hi = 0
    for b in acc:
        i = b & 0x3F
        if i < 32:
            lo |= 1 << i
        else:
            hi |= 1 << (i - 32)
    return lo, hi


_ACC3_LO, _ACC3_HI = _acc_mask_u64(_ACC_C3)
_ACC5_LO, _ACC5_HI = _acc_mask_u64(_ACC_C5)


def _ascii_masks(b):
    """Elementwise classes of ASCII bytes (numpy or torch int arrays)."""
    is_sp = b == 0x20
    is_S = (b == 9) | ((b >= 10) & (b <= 13)) | (b == 0)
    is_dig = (b >= 0x30) & (b <= 0x39)
    low = b | 32
    is_al = (low >= 0x61) & (low <= 0x7A) & (b < 0x80)
    return is_sp, is_S, is_dig, is_al


def _acc_member(cont_low6: torch.Tensor, lo_mask: int, hi_mask: int) -> torch.Tensor:
    """Membership of a continuation byte's low 6 bits in an accent set,
    via two 32-bit masks.  The reference shifts an int32 logically;
    torch's ``>>`` on int32 is arithmetic, so the masks live in int64,
    where they are non-negative and both shifts agree."""
    word = torch.where(cont_low6 >= 32, hi_mask, lo_mask)  # int64
    return ((word >> (cont_low6 & 31).to(torch.int64)) & 1) != 0


def _prev1(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(1), x])[: x.shape[0]]


def _prev2(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x.new_zeros(2), x])[: x.shape[0]]


def _next1(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1)])[1:]


def _start_mask_any(b, kill1, kill2):
    """Token-start mask over int32 byte values ``b``; ``kill1``/``kill2``
    are bool context resets (segment starts and the byte after).
    Requires the supported alphabet (see :func:`supported_alphabet`).
    """
    is_sp, is_S, is_dig, is_al = _ascii_masks(b)
    lead3 = b == 0xC3
    lead5 = b == 0xC5
    cont = (b & 0xC0) == 0x80
    low6 = b & 0x3F
    acc_cont = cont & (
        (_prev1(lead3) & _acc_member(low6, _ACC3_LO, _ACC3_HI))
        | (_prev1(lead5) & _acc_member(low6, _ACC5_LO, _ACC5_HI))
    )
    oth_cont = cont & ~acc_cont
    is_oth_ascii = (b < 0x80) & ~(is_sp | is_S | is_dig | is_al)
    mA = is_al | acc_cont | _next1(acc_cont)  # lead byte takes char class
    mO = is_oth_ascii | oth_cont | _next1(oth_cont)
    mD = is_dig

    psp = _prev1(is_sp) & ~kill1
    psp2 = _prev2(is_sp) & ~kill1 & ~kill2
    same = (
        (mA & _prev1(mA)) | (mD & _prev1(mD)) | (mO & _prev1(mO))
    ) & ~kill1
    content_start = (mA | mD | mO) & ~cont
    return (
        (is_sp & ~psp)
        | is_S
        | (content_start & ((psp & psp2) | (~psp & ~same)))
    )


def start_mask(chunk: torch.Tensor, seg_ends: torch.Tensor) -> torch.Tensor:
    """Token-start mask of a chunk tensor (uint8 [n]) whose documents
    end at ``seg_ends`` (int32, cumulative, last = n, each segment
    non-empty).  The 2-byte context resets at every segment start."""
    n = chunk.shape[0]
    dev = chunk.device
    seg_starts = torch.cat(
        [torch.zeros(1, dtype=torch.int64, device=dev), seg_ends[:-1].to(torch.int64)]
    )
    # one spare slot takes the reset after a segment's last byte, so no
    # index is filtered (a boolean filter would sync with the device)
    kill1 = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    kill2 = torch.zeros(n + 2, dtype=torch.bool, device=dev)
    kill1.index_fill_(0, seg_starts, True)
    kill2.index_fill_(0, seg_starts + 1, True)
    return _start_mask_any(chunk.to(torch.int32), kill1[:n], kill2[:n])


def supported_alphabet(chunk: np.ndarray) -> bool:
    """True when every byte >= 0x80 forms a valid 2-byte sequence led by
    0xC3/0xC5 (the native SIMD splitter's alphabet).  One vectorized
    pass; anything else routes to the host path."""
    high = chunk >= 0x80
    if not high.any():
        return True
    lead = (chunk == 0xC3) | (chunk == 0xC5)
    cont = (chunk & 0xC0) == 0x80
    if not ((lead | cont) == high).all():
        return False
    # every lead followed by a continuation; every continuation preceded
    # by a lead (no strays, no lead at the very end)
    nxt_cont = np.concatenate([cont[1:], [False]])
    prev_lead = np.concatenate([[False], lead[:-1]])
    return bool((~lead | nxt_cont).all() and (~cont | prev_lead).all())


def _cut_lut() -> np.ndarray:
    """256-entry content-class LUT for safe-cut candidates: 1=A 2=D 3=O
    for ASCII content bytes, 0 for space/single/high bytes."""
    t = np.zeros(256, dtype=np.uint8)
    for v in range(0x80):
        is_sp, is_S, is_dig, is_al = _ascii_masks(np.int32(v))
        if is_al:
            t[v] = 1
        elif is_dig:
            t[v] = 2
        elif not (is_sp or is_S):
            t[v] = 3
    return t


_CUT_LUT = _cut_lut()


def find_cut(chunk: np.ndarray, lo: int, hi: int) -> int:
    """Largest p in (lo, hi] that starts a new word regardless of any
    context before it: byte p-1 and byte p are both ASCII content bytes
    of DIFFERENT classes (see src/parser.c:24-88).  Returns -1 when the
    window has no such point."""
    if hi <= lo + 1:
        return -1
    c = _CUT_LUT[chunk[lo:hi]]
    ok = (c[1:] != 0) & (c[:-1] != 0) & (c[1:] != c[:-1])
    idx = np.flatnonzero(ok)
    if idx.size == 0:
        return -1
    return lo + 1 + int(idx[-1])


# ------------------------------------------------------------------ device


def chunk_words(chunk: torch.Tensor, seg_ends: torch.Tensor):
    """(word starts int64 [W], word lengths int64 [W]) of a non-empty
    chunk.  A word runs to the next start (or the chunk's
    end), so the lengths are differences of the starts.

    The one host sync of the chunk program is here: ``torch.nonzero``
    learns W.  (The reference instead scans every byte for its word
    start and the next one, ``cummax`` and a reversed ``cummin``; on the
    H100 those two generic scans took 90 % of a raw run's device time.)
    """
    word_start = torch.nonzero(start_mask(chunk, seg_ends)).squeeze(1)  # host sync: W
    end = torch.full((1,), chunk.shape[0], dtype=torch.int64, device=chunk.device)
    return word_start, torch.diff(word_start, append=end)


def encode_chunk(tab, chunk: torch.Tensor, seg_ends: torch.Tensor, *,
                 Fcap: int, u16_out: bool, span=None):
    """The raw chunk program (counterpart of ``_raw_encode_chunk_jit``,
    plain u16/i32 stream only).

    ``chunk`` uint8 [n > 0] and ``seg_ends`` int32 [n_docs] on the
    tables' device.  Returns ``(meta int32 [3 + n_docs + 3*Fcap],
    toks [n])``:

    * ``meta[0:3]`` = [W, T, F]: words, device tokens, flagged words;
    * ``meta[3 : 3+n_docs]``: device tokens in segments 0..d (flagged
      words excluded; the host adds them while splicing);
    * then ``Fcap`` records ``(byte_start, byte_len, token_insert_pos)``
      of words longer than 32 bytes, in byte order (only F <= Fcap are
      written; the host refuses the chunk otherwise);
    * ``toks``: the T ids in byte order, then filler; int16 holding
      uint16 bit patterns when ``u16_out``.

    ``span``, a traced call's span (``spans.py``) or None: under it
    ``chunk_words`` is recorded as ``engine.raw.nonzero_sync``, the wait
    for the device to reach the chunk's one host sync.
    """
    n = chunk.shape[0]
    dev = chunk.device
    sync = span and span.child("engine.raw.nonzero_sync")
    word_start, word_len = chunk_words(chunk, seg_ends)
    if sync:
        sync.close()
    long_w = word_len > MAX_WORD
    # long words go to the kernel with length 0: it skips them
    ids = seg_merge(
        tab, chunk, word_start.to(torch.int32),
        torch.where(long_w, 0, word_len).to(torch.int32),
    )

    # token stream: live ids compacted in byte order (= the reference's
    # row-major lane order); dropped bytes land in a spare last slot
    live = ids >= 0
    vc = torch.cumsum(live, dim=0)  # inclusive count of live bytes
    out_dtype = torch.int16 if u16_out else torch.int32
    toks = torch.zeros(n + 1, dtype=out_dtype, device=dev)
    toks.scatter_(0, torch.where(live, vc - 1, n), ids.to(out_dtype))

    # flag records of long words; a long word's bytes are never live, so
    # the inclusive count at its first byte is the tokens before it
    fc = torch.cumsum(long_w, dim=0)
    fdest = torch.where(long_w, (fc - 1).clamp(max=Fcap), Fcap)
    frecs = torch.zeros((3, Fcap + 1), dtype=torch.int64, device=dev)
    for row, val in enumerate((word_start, word_len, vc[word_start])):
        frecs[row].scatter_(0, fdest, val)

    W = torch.full((1,), word_start.shape[0], dtype=torch.int64, device=dev)
    doc_cum = vc[seg_ends.to(torch.int64) - 1]
    meta = torch.cat([W, vc[-1:], fc[-1:], doc_cum, frecs[:, :Fcap].t().reshape(-1)])
    return meta.to(torch.int32), toks[:n]


class RawChunkEncoder:
    """The host side of :func:`encode_chunk`, with the reference's
    ``launch(chunk, seg_ends)`` / ``finish(handles, chunk)`` contract.

    ``launch`` stages the chunk in pinned memory, runs the chunk program
    on the tokenizer's device and starts non-blocking copies of the meta
    block and of the token stream into pinned buffers, each with a CUDA
    event (the tokenizer's ``_to_device``/``_start_copy``).  ``finish``
    waits on them and splices flagged words on the exact host path.
    Launch from one thread: the current stream is per thread.
    """

    def __init__(self, tokenizer, C: int = 1 << 22, Fcap: int = 4096,
                 Dcap: int = 4096):
        # no buffer depends on the token count: the stream has a slot per
        # byte.  Fcap sizes the flag records (no sync to learn F); Dcap is
        # the most documents the engine's producer puts in one chunk
        self.C = C
        self.Fcap = Fcap
        self.Dcap = Dcap
        self.tok = tokenizer
        self.tab = tokenizer.dev_tables
        self.u16 = tokenizer._u16_out

    def launch(self, chunk_np: np.ndarray, seg_ends: np.ndarray):
        """Launch one chunk (uint8, at most C bytes, documents ending at
        the int32 cumulative ``seg_ends``).  Returns opaque handles for
        :meth:`finish`, which carry the traced call's span, if any, to
        the thread that finishes the chunk."""
        tok = self.tok
        call = tok.spans.current()
        meta, toks = encode_chunk(
            self.tab, tok._to_device(chunk_np), tok._to_device(seg_ends),
            Fcap=self.Fcap, u16_out=self.u16, span=call,
        )
        # the stream's length T is on the device: copy all n slots back
        # rather than wait for the meta block first
        return (tok._start_copy(meta), tok._start_copy(toks), seg_ends.shape[0], seg_ends,
                call)

    def finish(self, handles, chunk_np: np.ndarray):
        """Wait for one launch; returns ``(tokens int32 [T'], seg_counts
        int64 [n_docs], stats)`` with flagged words spliced in, or None
        when the chunk has more than Fcap long words and must be encoded
        on the host.  ``stats``: device_bytes, words, flagged_words and
        host bytes by cause (``over_bucket`` = word > 32 bytes,
        ``partial_flag``, always 0 with the full table).

        ``chunk_np`` must be the bytes given to :meth:`launch`."""
        meta_staged, toks_staged, n_docs, seg_ends, call = handles
        wait = call and call.child("engine.raw.copy_wait")
        meta = self.tok._host_view(meta_staged)
        W, T, F = (int(x) for x in meta[:3])
        if F > self.Fcap:
            return None
        toks = self.tok._host_view(toks_staged)[:T].astype(np.int32)
        if wait:
            wait.close()
        seg_counts = np.diff(meta[3 : 3 + n_docs].astype(np.int64), prepend=0)
        n = chunk_np.shape[0]
        stats = {
            "device_bytes": n,
            "words": W,
            "flagged_words": F,
            "over_bucket": 0,
            "partial_flag": 0,
        }
        if F == 0:
            return toks, seg_counts, stats
        fr = meta[3 + n_docs : 3 + n_docs + 3 * F].reshape(F, 3)
        # records come in byte order, so insert positions are sorted
        splice = call and call.child("engine.raw.splice")
        parts: list[np.ndarray] = []
        cursor = 0
        for bstart, blen, tpos in fr.tolist():
            parts.append(toks[cursor:tpos])
            wb = chunk_np[bstart : bstart + blen].tobytes()
            enc = np.asarray(self.tok._encode_word_host(wb, None), dtype=np.int32)
            parts.append(enc)
            # the extra tokens belong to the segment of the word's first
            # byte (tpos can sit exactly on a segment boundary)
            seg_counts[int(np.searchsorted(seg_ends, bstart, side="right"))] += enc.shape[0]
            cursor = tpos
            stats["over_bucket"] += blen
        parts.append(toks[cursor:])
        stats["device_bytes"] = n - stats["over_bucket"]
        out = np.concatenate(parts)
        if splice:
            splice.close()
        return out, seg_counts, stats
