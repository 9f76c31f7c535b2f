"""The encoder state the device needs, carried over from the JAX package.

``hutoken_tpu.tables.build_encoder_tables`` builds every table in numpy;
this module only moves the parts the merge path reads onto a
``torch.device``, so both packages compute from the same numbers.

Two pair-table layouts, chosen by the vocabulary: the narrow packed
table (16-bit ids and ranks, two int32 words per slot) that every
vocabulary with ids and ranks below 0xFFFF keeps, and a wide table of
16-byte slots for the rest (100k+ vocabularies), which the JAX package
serves with ``MODE_PROBE`` and the R-matrix programs instead.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hutoken_tpu.context import TokenizerContext
from hutoken_tpu.tables import EncoderTables, build_pair_table

# probe bound of the wide table's rebuild: the default of 4 makes a
# 157k-pair table 4-8 M slots (64-128 MB at 16 B a slot, past the 50 MB
# L2); 16 keeps it at 0.25-0.5 M slots, and probing stops at the first
# empty slot anyway
WIDE_MAX_PROBE = 16
# the merge kernel's candidate rank * 32 + lane is a 32-bit unsigned
# value below its 0x7FFFFFFF sentinel
MAX_WIDE_RANK = (1 << 26) - 1


@dataclass(frozen=True)
class DeviceTables:
    """Open-addressed pair table plus the byte LUT and the multi-merge
    bound, as tensors on one device.  Slot = mix hash & ``cap_mask``,
    linear probing up to ``probe_len`` slots, in either layout:

    * narrow (``slots`` None): ``pkey[s]`` = ``left << 16 | right`` as
      an int32 bit pattern (-1 = empty), ``pval[s]`` = ``rank << 16 |
      merged`` (``hutoken_tpu/tables.py`` ``PairTable.packed_arrays``);
    * wide (``pkey``/``pval`` None): ``slots[s]`` = ``(left, right,
      rank, merged)`` in full 32 bits, ``left`` -1 when empty, so one
      16-byte load reads a slot's key and value together.
    """

    pkey: Optional[torch.Tensor]  # int32 [C], narrow only
    pval: Optional[torch.Tensor]  # int32 [C], narrow only
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
        return (self.slots if self.wide else self.pkey).device


def build_minsuper(
    pairs: dict[tuple[int, int], tuple[int, int]],
    id2str: dict[int, bytes],
) -> Optional[np.ndarray]:
    """minsuper[r] = min rank over pairs whose concatenated spelling
    strictly contains the spelling of a rank-r pair (0xFFFF if none).

    Same function as ``hutoken_tpu/ops/pallas_merge.py::build_minsuper``,
    which cannot be imported without JAX.  It certifies the multi-merge
    guard: a neighbour pair of current rank r can only ever take ranks
    >= minsuper[r] (or none).  None when a rank does not fit 16 bits or a
    spelling is missing; the kernel then runs single-merge rounds.
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
    and rank fits 16 bits, else the wide table, rebuilt from
    ``enc.pairs`` with a probe bound of ``WIDE_MAX_PROBE``."""
    pt = enc.pair_table
    device = torch.device(device)
    pkey = pval = slots = None
    if pt.packed_ok:
        pkey, pval = (torch.from_numpy(x).to(device) for x in pt.packed_arrays())
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
        ms = build_minsuper(enc.pairs, ctx.vocab.id2str)
        if ms is not None:
            minsuper = torch.from_numpy(ms).to(device)
    return DeviceTables(
        pkey=pkey,
        pval=pval,
        slots=slots,
        probe_len=pt.probe_len,
        cap_mask=pt.capacity - 1,
        byte_seed=byte_seed,
        minsuper=minsuper,
    )
