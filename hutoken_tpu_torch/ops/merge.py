"""The greedy BPE merge fixed point in PyTorch (port of
``hutoken_tpu/ops/merge.py``: the packed-table and the wide-table
probes; the one-hot MXU probe targets the TPU's matrix unit and is not
ported).

Per round every word applies its single (rank, leftmost)-minimum pair,
which is exactly the sequential greedy order of the reference
(src/core.c:66-209); words advance in lockstep.  The fixed point and its
packings are the plain twin of the id merge kernel
(``ops/id_merge.py``), which serves words of 33-128 bytes and char-mode
id blocks on the card; the probes are also the fused kernel's twin's.

The narrow packed table stores ids and ranks in 16 bits; vocabularies
that do not fit get the wide table (``tables.DeviceTables``), and
:func:`probe_pairs` picks the probe by the table's layout.
"""

from __future__ import annotations

import torch

INF_RANK = 0x7FFFFFFF
_U32 = 0xFFFFFFFF


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """(x * c) mod 2**32 for int64 x in [0, 2**32) without int64
    overflow: the constant is split into 16-bit halves."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def hash_slots(a: torch.Tensor, b: torch.Tensor, cap_mask: int) -> torch.Tensor:
    """``tables._mix_hash(a, b) & cap_mask`` as int64, bit for bit.

    The reference hashes in uint32 with logical shifts.  Torch's ``>>``
    on int32 is arithmetic and its uint32 support is partial, so the
    hash runs on the uint32 bit pattern held in int64 (-1 -> 0xFFFFFFFF,
    as ``astype(uint32)`` gives).
    """
    au = a.to(torch.int64) & _U32
    bu = b.to(torch.int64) & _U32
    h = _mul32(au, 0x85EBCA6B) ^ _mul32(bu, 0xC2B2AE35)
    h = h ^ (h >> 13)
    h = _mul32(h, 0x27D4EB2F)
    h = h ^ (h >> 15)
    return h & cap_mask


def pack_key(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``(a << 16) | (b & 0xFFFF)`` as the int32 bit pattern that
    ``PairTable.packed_arrays`` stores.  Keys with a left id >= 0x8000
    are negative int32, so the key is built in int64 and wrapped."""
    k = ((a.to(torch.int64) & 0xFFFF) << 16) | (b.to(torch.int64) & 0xFFFF)
    return torch.where(k >= 1 << 31, k - (1 << 32), k).to(torch.int32)


def probe_pairs_packed(tab, a: torch.Tensor, b: torch.Tensor):
    """(rank, merged) int32 for id pairs; (INF_RANK, -1) when the pair
    has no rule or either side is PAD (-1).  Port of
    ``_probe_pairs_packed`` (merge.py:74): one key gather per probe step,
    one value gather at the hit slot, from the key and value columns of
    ``tab.pslots``."""
    if tab.pslots is None:
        raise ValueError(
            "a wide pair table has no packed keys (a 16-bit key would alias "
            "(0x10001, 5) with (1, 5)): use probe_pairs_wide"
        )
    h = hash_slots(a, b, tab.cap_mask)
    key = pack_key(a, b)
    found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    slot_hit = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for i in range(tab.probe_len):
        slot = (h + i) & tab.cap_mask
        hit = ~found & (tab.pslots[slot, 0] == key)
        slot_hit = torch.where(hit, slot, slot_hit)
        found |= hit
    v = tab.pslots[slot_hit, 1]
    valid = found & (a >= 0) & (b >= 0)
    rank = torch.where(valid, (v >> 16) & 0xFFFF, INF_RANK)
    merged = torch.where(valid, v & 0xFFFF, -1)
    return rank.to(torch.int32), merged.to(torch.int32)


def probe_pairs_wide(tab, a: torch.Tensor, b: torch.Tensor):
    """:func:`probe_pairs_packed` on the wide table's ``[C, 4]`` slots,
    comparing both ids in full 32 bits.  Port of ``probe_pairs``
    (merge.py:104) in ``MODE_PROBE``, with the same hash and the same
    (INF_RANK, -1) for a miss or a PAD side."""
    h = hash_slots(a, b, tab.cap_mask)
    found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    slot_hit = torch.zeros(a.shape, dtype=torch.int64, device=a.device)
    for i in range(tab.probe_len):
        slot = (h + i) & tab.cap_mask
        key = tab.slots[slot]
        hit = ~found & (key[..., 0] == a) & (key[..., 1] == b)
        slot_hit = torch.where(hit, slot, slot_hit)
        found |= hit
    v = tab.slots[slot_hit]
    valid = found & (a >= 0) & (b >= 0)
    rank = torch.where(valid, v[..., 2], INF_RANK)
    merged = torch.where(valid, v[..., 3], -1)
    return rank.to(torch.int32), merged.to(torch.int32)


def probe_pairs(tab, a: torch.Tensor, b: torch.Tensor):
    """The probe of ``tab``'s layout: wide or narrow packed."""
    return (probe_pairs_wide if tab.wide else probe_pairs_packed)(tab, a, b)


def _shift_left(x: torch.Tensor, fill: int) -> torch.Tensor:
    """x[:, 1:] with ``fill`` appended: column i holds x[:, i + 1]."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def merge_fixed_point(tab, ids: torch.Tensor) -> torch.Tensor:
    """Greedy merge of a padded int32 [W, L] block (PAD = -1); returns
    the merged ids with PAD filling the freed tail.  Port of
    ``_merge_fixed_point`` (merge.py:247) as an eager loop: one
    ``.any()`` host sync per round.  The plain twin of
    ``ops/id_merge.py``'s kernel; each call adds one to
    ``merge_fixed_point.calls``."""
    merge_fixed_point.calls += 1
    W, L = ids.shape
    col = torch.arange(L, device=ids.device)
    rows = torch.arange(W, device=ids.device)
    ranks, merged = probe_pairs(tab, ids, _shift_left(ids, -1))
    while True:
        min_rank = ranks.min(dim=1).values
        active = min_rank < INF_RANK
        if not bool(active.any()):
            return ids
        # leftmost position attaining the row's minimum rank
        p = torch.where(ranks == min_rank[:, None], col, L).min(dim=1).values
        p = torch.where(active, p, 0)
        m = merged[rows, p]
        after = (col[None, :] > p[:, None]) & active[:, None]
        at = (col[None, :] == p[:, None]) & active[:, None]
        # apply: ids[p] = merged, the suffix shifts left, the tail is PAD
        ids = torch.where(after, _shift_left(ids, -1), torch.where(at, m[:, None], ids))
        ranks = torch.where(after, _shift_left(ranks, INF_RANK), ranks)
        merged = torch.where(after, _shift_left(merged, -1), merged)
        # re-probe the two pairs the merge touched: (p-1, p) and (p, p+1)
        left = torch.where(p > 0, ids[rows, (p - 1).clamp(min=0)], -1)
        right = torch.where(p + 1 <= L - 1, ids[rows, (p + 1).clamp(max=L - 1)], -1)
        r2, m2 = probe_pairs(tab, torch.stack([left, m]), torch.stack([m, right]))
        before = (col[None, :] == (p - 1)[:, None]) & active[:, None]
        ranks = torch.where(before, r2[0][:, None], torch.where(at, r2[1][:, None], ranks))
        merged = torch.where(before, m2[0][:, None], torch.where(at, m2[1][:, None], merged))


merge_fixed_point.calls = 0


def compact_output(out_ids: torch.Tensor, u16_out: bool) -> torch.Tensor:
    """Pack a merged [W, L] block (PAD = -1) into ONE 1-D tensor
    ``[W + W*L]``: per-row token counts, then every valid token compacted
    row-major (port of ``_compact_output``, merge.py:333).  The host then
    copies only a prefix of it.

    ``u16_out`` returns int16 holding the uint16 bit patterns (torch's
    uint16 lacks most ops); the host views the copy as ``np.uint16``.
    Its ops run under a profiler span named ``compact_output``.
    """
    with torch.profiler.record_function("compact_output"):
        W, L = out_ids.shape
        valid = out_ids >= 0
        counts = valid.sum(dim=1, dtype=torch.int32)
        row_base = torch.cumsum(counts, 0) - counts
        pos = torch.cumsum(valid.to(torch.int32), dim=1) - 1
        dest = (row_base[:, None] + pos)[valid].to(torch.int64)
        flat = torch.zeros(W * L, dtype=torch.int32, device=out_ids.device)
        flat[dest] = out_ids[valid].to(torch.int32)
        packed = torch.cat([counts, flat])
        return packed.to(torch.int16) if u16_out else packed


def seed_from_bytes(byte_seed: torch.Tensor, raw: torch.Tensor, lens: torch.Tensor):
    """uint8 word bytes [W, L] + lens [W] -> seed ids int32 (PAD = -1)
    through the 256-entry LUT (merge.py:414)."""
    L = raw.shape[1]
    col = torch.arange(L, device=raw.device)
    ids = byte_seed[raw.to(torch.int64)]
    return torch.where(col[None, :] < lens[:, None], ids, -1)


def merge_words_packed(tab, ids: torch.Tensor, u16_out: bool) -> torch.Tensor:
    """Fixed point over an id block, in the packed output layout
    (merge.py:377), on either table layout."""
    return compact_output(merge_fixed_point(tab, ids), u16_out)


def merge_words_from_bytes_packed(
    tab, raw: torch.Tensor, lens: torch.Tensor, u16_out: bool
) -> torch.Tensor:
    """Byte-mode fixed point in the packed output layout (merge.py:402),
    on either table layout."""
    ids = seed_from_bytes(tab.byte_seed, raw, lens)
    return compact_output(merge_fixed_point(tab, ids), u16_out)
