"""The encoder tables: built on the host in numpy, then moved to a
``torch.device`` for the merge path.

The host builders (``PairTable``, ``build_pair_table``,
``EncoderTables``, ``build_encoder_tables`` and their helpers) are the
port's own copy of ``hutoken_tpu/tables.py``, so that the port imports
nothing of the JAX package; ``tests/test_torch_host.py`` holds every
array they build equal to the original's.  Their notes:

* **Pair-rank hash table**: open-addressed, power-of-two capacity,
  linear probing with a build-time maximum probe length, four parallel
  int32 arrays (left, right, rank, merged).  On the *string path* (no
  merges.txt) the rank of a pair is the vocab id of the concatenated
  spelling (reference: src/core.c:700-722), enumerated over every split
  of every vocab token whose halves are both vocab tokens; on the *id
  path* (merges.txt) it is the rule's line rank (reference:
  src/lib.c:604-652, src/core.c:724-736).
* **byte -> initial id**: the special-chars replacement, the >= 0x80
  2-byte expansion and the per-char vocab lookup composed (reference:
  src/pretokenizer.c:56-73 + src/core.c:460-474).
* **decode byte table**: ``token_bytes[V, max_len]`` + ``lens[V]``
  (reference: src/lib.c:422-448).

:func:`device_tables` moves what the merge path reads onto a device, in
one of two pair-table layouts chosen by the vocabulary: the narrow
packed table (16-bit ids and ranks) that every vocabulary whose ids and
ranks all lie below 0xFFFF keeps, and a wide table of 16-byte slots for
the rest (100k+ vocabularies, or a few ids past 16 bits), which the JAX
package serves with ``MODE_PROBE`` and the R-matrix programs instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from .bytemaps import utf8_char_length
from .context import TokenizerContext
from .pretokenize import encode_remap

INF_RANK = np.int32(0x7FFFFFFF)


def _mix_hash(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit mix of an id pair (same shape in/out, uint32).

    Wraparound is intended; must match the device probe in ops/merge.py.
    """
    with np.errstate(over="ignore"):
        h = a.astype(np.uint32) * np.uint32(0x85EBCA6B)
        h ^= b.astype(np.uint32) * np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0x27D4EB2F)
        h ^= h >> np.uint32(15)
    return h


@dataclass
class PairTable:
    """Open-addressed (left,right) -> (rank, merged) table."""

    left: np.ndarray  # int32 [C], -1 = empty
    right: np.ndarray  # int32 [C]
    rank: np.ndarray  # int32 [C]
    merged: np.ndarray  # int32 [C]
    probe_len: int  # max displacement + 1: bounded unconditional probing
    num_pairs: int
    onehot_ok: bool = False  # capacity and values fit the MXU one-hot probe

    @property
    def capacity(self) -> int:
        return int(self.left.shape[0])

    @property
    def packed_ok(self) -> bool:
        """Every id/rank fits 16 bits -> the 1-gather-per-step packed
        probe layout applies (ops/merge.py MODE_PACKED)."""
        if self.num_pairs == 0:
            return True
        real = self.left >= 0
        hi = 0
        for arr in (self.left, self.right, self.rank, self.merged):
            if real.any():
                hi = max(hi, int(arr[real].max()))
        return hi < 0xFFFF

    def packed_arrays(self) -> tuple[np.ndarray, np.ndarray]:
        """(pkey, pval) int32 arrays: key = left<<16|right (-1 = empty),
        value = rank<<16|merged."""
        with np.errstate(over="ignore"):
            pkey = (
                (self.left.astype(np.uint32) << 16)
                | (self.right.astype(np.uint32) & 0xFFFF)
            ).astype(np.int32)
            pkey = np.where(self.left < 0, np.int32(-1), pkey)
            pval = (
                (np.minimum(self.rank, 0xFFFF).astype(np.uint32) << 16)
                | (self.merged.astype(np.uint32) & 0xFFFF)
            ).astype(np.int32)
        return pkey, pval


def build_pair_table(
    pairs: dict[tuple[int, int], tuple[int, int]], max_probe_len: int = 4
) -> PairTable:
    """Insert all pairs with linear probing.

    Capacity starts at load factor 0.5 and doubles until the maximum
    displacement fits ``max_probe_len`` — short unconditional probe
    chains keep the device graph small and the per-lookup cost flat.

    The same table as the original's, slot for slot (pairs go in in
    dict order), with the hashes computed once for every capacity tried
    and the probing done on Python lists rather than numpy scalars.
    """
    n = max(len(pairs), 1)
    cap = 1
    while cap < 2 * n:
        cap *= 2
    cols = np.array([(a, b, r, m) for (a, b), (r, m) in pairs.items()],
                    dtype=np.int64).reshape(-1, 4)
    hashes = _mix_hash(cols[:, 0].astype(np.uint32), cols[:, 1].astype(np.uint32)).tolist()
    while True:
        mask = cap - 1
        used = bytearray(cap)
        slot = [0] * len(hashes)
        max_disp = 0
        ok = True
        for i, h in enumerate(hashes):
            h &= mask
            disp = 0
            while used[h]:
                h = (h + 1) & mask
                disp += 1
                if disp > 64:
                    ok = False
                    break
            if not ok:
                break
            used[h] = 1
            slot[i] = h
            if disp > max_disp:
                max_disp = disp
        if ok and max_disp + 1 > max_probe_len and cap < (1 << 24):
            ok = False  # too much clustering: grow for shorter probes
        if ok:
            left = np.full(cap, -1, dtype=np.int32)
            right = np.full(cap, -1, dtype=np.int32)
            rank = np.full(cap, INF_RANK, dtype=np.int32)
            merged = np.full(cap, -1, dtype=np.int32)
            for arr, col in zip((left, right, rank, merged), cols.T):
                arr[slot] = col
            max_val = max(int(cols.max()) if len(cols) else 0, 0)
            onehot_ok = cap <= 16384 and max_val < (1 << 24)
            return PairTable(
                left=left,
                right=right,
                rank=rank,
                merged=merged,
                probe_len=max_disp + 1,
                num_pairs=len(pairs),
                onehot_ok=onehot_ok,
            )
        cap *= 2  # pathological clustering: grow and retry


def enumerate_string_pairs(str2id: dict[bytes, int]) -> dict[tuple[int, int], tuple[int, int]]:
    """All (left_id, right_id) with concat spelling in the vocab.

    Equivalent to the reference's on-the-fly concat+lookup rank
    (src/core.c:700-722) restricted to elements that are vocab tokens.
    """
    pairs: dict[tuple[int, int], tuple[int, int]] = {}
    for token, tid in str2id.items():
        if len(token) < 2:
            continue
        for k in range(1, len(token)):
            a = str2id.get(token[:k])
            if a is None:
                continue
            b = str2id.get(token[k:])
            if b is None:
                continue
            pairs[(a, b)] = (tid, tid)
    return pairs


def merges_pairs(ctx: TokenizerContext) -> dict[tuple[int, int], tuple[int, int]]:
    assert ctx.merges is not None
    return dict(ctx.merges.rules)



@dataclass
class EncoderTables:
    pair_table: PairTable
    # byte mode: byte value -> list of seed element ids (usually length 1;
    # a replacement spelling may seed several elements)
    byte_seed_ids: Optional[np.ndarray]  # int32 [256] when all single-element
    byte_seed_fallback: Optional[dict[int, list[int]]]
    vocab_size: int
    is_byte_encoder: bool
    uses_merges: bool
    # decode side
    token_bytes: np.ndarray  # uint8 [V, max_len]
    token_lens: np.ndarray  # int32 [V]
    # raw (left,right)->(rank,merged) dict, kept so callers can rebuild
    # the table at a different load factor (e.g. probe_len=2 for the
    # packed big-table probe)
    pairs: dict

    def seed_ids_for_byte(self, b: int) -> list[int]:
        if self.byte_seed_ids is not None:
            v = int(self.byte_seed_ids[b])
            return [v]
        return self.byte_seed_fallback[b]


def _seed_elements_of_spelling(spelling: bytes) -> list[bytes]:
    """Split a remapped spelling into seed elements (per UTF-8 char, with
    <0xNN> literals whole — src/core.c:49-55,483-487)."""
    from .bytemaps import hex_token_length

    out = []
    i = 0
    while i < len(spelling):
        ln = hex_token_length(spelling, i)
        if ln <= 0:
            ln = utf8_char_length(spelling[i])
        out.append(spelling[i : i + ln])
        i += ln
    return out


def build_encoder_tables(ctx: TokenizerContext) -> EncoderTables:
    str2id = ctx.vocab.str2id
    if ctx.merges is not None:
        pairs = merges_pairs(ctx)
        uses_merges = True
    else:
        pairs = enumerate_string_pairs(str2id)
        uses_merges = False
    table = build_pair_table(pairs)

    byte_seed_ids: Optional[np.ndarray] = None
    byte_seed_fallback: Optional[dict[int, list[int]]] = None
    if ctx.is_byte_encoder:
        per_byte: dict[int, Optional[list[int]]] = {}
        all_single = True
        for b in range(256):
            spelled = encode_remap(bytes([b]), ctx.special_chars, None, True)
            if uses_merges:
                # id path seeds per UTF-8 char (src/core.c:460-474)
                elems = []
                i = 0
                while i < len(spelled):
                    ln = utf8_char_length(spelled[i])
                    elems.append(spelled[i : i + ln])
                    i += ln
            else:
                elems = _seed_elements_of_spelling(spelled)
            ids = [str2id.get(e) for e in elems]
            if any(i is None for i in ids):
                per_byte[b] = None  # word containing b goes to host fallback
                all_single = False
            else:
                per_byte[b] = [int(i) for i in ids]
                if len(ids) != 1:
                    all_single = False
        if all_single:
            byte_seed_ids = np.array(
                [per_byte[b][0] for b in range(256)], dtype=np.int32
            )
        byte_seed_fallback = {
            b: (v if v is not None else []) for b, v in per_byte.items()
        }

    # decode tables
    vocab_size = ctx.vocab.size
    max_len = max((len(s) for s in ctx.vocab.id2str.values()), default=1)
    max_len = max(max_len, 1)
    token_bytes = np.zeros((max(vocab_size, 1), max_len), dtype=np.uint8)
    token_lens = np.zeros(max(vocab_size, 1), dtype=np.int32)
    for tid, s in ctx.vocab.id2str.items():
        if 0 <= tid < vocab_size:
            token_bytes[tid, : len(s)] = np.frombuffer(s, dtype=np.uint8)
            token_lens[tid] = len(s)

    return EncoderTables(
        pair_table=table,
        byte_seed_ids=byte_seed_ids,
        byte_seed_fallback=byte_seed_fallback,
        vocab_size=vocab_size,
        is_byte_encoder=ctx.is_byte_encoder,
        uses_merges=uses_merges,
        token_bytes=token_bytes,
        token_lens=token_lens,
        pairs=pairs,
    )


# probe bound of the wide table's rebuild: the default of 4 makes a
# 157k-pair table 4-8 M slots (64-128 MB at 16 B a slot, past the 50 MB
# L2); 16 keeps it at 0.25-0.5 M slots, and probing stops at the first
# empty slot anyway
WIDE_MAX_PROBE = 16
# the merge kernel's candidate rank * 32 + lane is a 32-bit unsigned
# value below its 0x7FFFFFFF sentinel
MAX_WIDE_RANK = (1 << 26) - 1
# the longest word, in raw bytes, that the merge kernels read the
# minsuper bound for (``ops/fused_merge.py::MAX_WORD``, which this module
# does not import: ``ops/`` imports it)
KERNEL_WORD_BYTES = 32


def max_token_id(vocab) -> int:
    """The largest id of a vocabulary (-1 when it is empty): the bound of
    every id the encoder can emit.  A vocabulary with id holes keeps its
    line count (``vocab.size``) far below it."""
    return max(max(vocab.id2str, default=-1), max(vocab.str2id.values(), default=-1))


@dataclass(frozen=True)
class DeviceTables:
    """Open-addressed pair table plus the byte LUT and the multi-merge
    bound, as tensors on one device.  Slot = mix hash & ``cap_mask``,
    linear probing up to ``probe_len`` slots, in either layout:

    * narrow (``slots`` None): ``pslots[s]`` = ``(key, value,
      minsuper[rank] or 0, 0)``, where key = ``left << 16 | right`` as
      an int32 bit pattern (-1 = empty) and value = ``rank << 16 |
      merged``, the ``PairTable.packed_arrays`` pair: one 16-byte load
      a probe step brings key, value and the multi-merge bound together
      (0 in empty slots, and everywhere when ``minsuper`` is None); the
      eager probe reads the key and value columns;
    * wide (``pslots`` None): ``slots[s]`` =
      ``(left, right, rank, merged)`` in full 32 bits, ``left`` -1 when
      empty, so one 16-byte load reads a slot's key and value together.
    """

    pslots: Optional[torch.Tensor]  # int32 [C, 4], narrow only
    slots: Optional[torch.Tensor]  # int32 [C, 4], wide only
    probe_len: int
    cap_mask: int
    byte_seed: Optional[torch.Tensor]  # int32 [256]; None outside byte mode
    minsuper: Optional[torch.Tensor]  # int32 [max_rank + 1]; None = single merges

    @property
    def wide(self) -> bool:
        return self.slots is not None

    @property
    def device(self) -> torch.device:
        return (self.slots if self.wide else self.pslots).device

    def to(self, device: torch.device | str) -> "DeviceTables":
        """The same tables on ``device`` (``self`` when already there): a
        replica for another shard's device, with no rebuild."""
        device = torch.device(device)
        if device == self.device:
            return self

        def move(t):
            return None if t is None else t.to(device)

        return DeviceTables(
            pslots=move(self.pslots), slots=move(self.slots), probe_len=self.probe_len,
            cap_mask=self.cap_mask, byte_seed=move(self.byte_seed), minsuper=move(self.minsuper),
        )


def minsuper_spelling_cap(byte_seed_ids: np.ndarray, id2str: dict[int, bytes]) -> int:
    """The longest spelling, in bytes, of a pair that can form inside a
    word the merge kernels take.  A word holds at most
    ``KERNEL_WORD_BYTES`` raw bytes, each seeded by one token, and every
    token formed from it is spelled as the concatenation of its bytes'
    seed spellings: at most that many times the longest seed spelling (2
    bytes for a GPT-2 byte encoder, whose seeds are 1- or 2-byte UTF-8
    characters; so a cap of ``KERNEL_WORD_BYTES`` spelled bytes would
    miss pairs of accented words)."""
    longest = max((len(id2str.get(int(i), b"")) for i in byte_seed_ids), default=1)
    return KERNEL_WORD_BYTES * max(longest, 1)


def build_minsuper(
    pairs: dict[tuple[int, int], tuple[int, int]],
    id2str: dict[int, bytes],
    max_spelling: Optional[int] = None,
) -> Optional[np.ndarray]:
    """minsuper[r] = min rank over pairs whose concatenated spelling
    strictly contains the spelling of a rank-r pair (0xFFFF if none).

    Same function as ``hutoken_tpu/ops/pallas_merge.py::build_minsuper``,
    which cannot be imported without JAX.  It certifies the multi-merge
    guard: a neighbour pair of current rank r can only ever take ranks
    >= minsuper[r] (or none).  None when a rank does not fit 16 bits or a
    spelling is missing; the kernel then runs single-merge rounds.

    ``max_spelling`` (:func:`minsuper_spelling_cap`) leaves out the
    containing pairs spelled longer: they never form inside a word the
    kernels take, so they can lower no bound those words rely on.  The
    loop visits every substring of every containing spelling and every
    pair spelled as that substring: on a vocabulary's prefix chain of n
    bytes, whose every split is a pair, about n^4 / 24 visits, minutes
    for a 600-byte chain.  With the cap no spelling longer than it is
    visited.
    """
    if not pairs:
        return np.full(1, 0xFFFF, dtype=np.int32)
    max_rank = max(r for r, _m in pairs.values())
    if max_rank >= 0xFFFF:
        return None
    ms = np.full(max_rank + 1, 0xFFFF, dtype=np.int32)
    by_str: dict[bytes, list[int]] = {}
    str_minrank: dict[bytes, int] = {}
    for (a, b), (r, _m) in pairs.items():
        sa = id2str.get(a)
        sb = id2str.get(b)
        if sa is None or sb is None:
            return None
        s = sa + sb
        by_str.setdefault(s, []).append(r)
        prev = str_minrank.get(s)
        if prev is None or r < prev:
            str_minrank[s] = r
    for t, minrank_t in str_minrank.items():
        n = len(t)
        if max_spelling is not None and n > max_spelling:
            continue
        for ln in range(2, n):  # pair spellings have length >= 2
            for st in range(0, n - ln + 1):
                for r in by_str.get(t[st : st + ln], ()):
                    if minrank_t < ms[r]:
                        ms[r] = minrank_t
    return ms


def device_tables(
    enc: EncoderTables, ctx: TokenizerContext, device: torch.device | str
) -> DeviceTables:
    """Move ``enc``'s pair table, byte LUT and (byte mode only) the
    minsuper bound to ``device``: the narrow packed table when every id
    the encoder can emit and every rank fits 16 bits, else the wide
    table, rebuilt from ``enc.pairs`` with a probe bound of
    ``WIDE_MAX_PROBE``.

    The emitted ids count, not only the pairs' ids: the narrow probe key
    keeps 16 bits of each side, so a byte seed at 70,002 would probe as
    4,466 and could hit the pair (4,466, b).  ``ctx`` None (tables built
    by hand) bounds them by the pairs and the byte seeds alone."""
    pt = enc.pair_table
    device = torch.device(device)
    ms = None
    if enc.byte_seed_ids is not None:
        id2str = ctx.vocab.id2str
        ms = build_minsuper(enc.pairs, id2str, minsuper_spelling_cap(enc.byte_seed_ids, id2str))
    top = -1 if ctx is None else max_token_id(ctx.vocab)
    if enc.byte_seed_ids is not None and enc.byte_seed_ids.size:
        top = max(top, int(enc.byte_seed_ids.max()))
    pslots = slots = None
    if pt.packed_ok and top < 0xFFFF:
        pkey, pval = pt.packed_arrays()
        ms_slot = np.zeros(pt.capacity, dtype=np.int32)
        if ms is not None:
            real = pt.left >= 0
            ms_slot[real] = ms[pt.rank[real]]
        packed = np.stack([pkey, pval, ms_slot, np.zeros_like(ms_slot)], axis=1)
        pslots = torch.from_numpy(np.ascontiguousarray(packed)).to(device)
    else:
        max_rank = max(r for r, _m in enc.pairs.values())
        if max_rank > MAX_WIDE_RANK:
            raise ValueError(
                f"pair rank {max_rank} does not fit the merge kernel: its "
                f"candidate rank * 32 + lane is 32-bit, so ranks stop at {MAX_WIDE_RANK}"
            )
        pt = build_pair_table(enc.pairs, max_probe_len=WIDE_MAX_PROBE)
        # empty slots keep left = right = merged = -1, rank INF_RANK
        wide = np.stack([pt.left, pt.right, pt.rank, pt.merged], axis=1)
        slots = torch.from_numpy(np.ascontiguousarray(wide, dtype=np.int32)).to(device)
    byte_seed = minsuper = None
    if enc.byte_seed_ids is not None:
        byte_seed = torch.from_numpy(enc.byte_seed_ids.astype(np.int32)).to(device)
    if ms is not None:
        minsuper = torch.from_numpy(ms).to(device)
    return DeviceTables(
        pslots=pslots,
        slots=slots,
        probe_len=pt.probe_len,
        cap_mask=pt.capacity - 1,
        byte_seed=byte_seed,
        minsuper=minsuper,
    )
