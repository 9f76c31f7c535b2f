"""The encoder state the device needs, carried over from the JAX package.

``hutoken_tpu.tables.build_encoder_tables`` builds every table in numpy;
this module only moves the parts the merge path reads onto a
``torch.device``, so both packages compute from the same numbers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from hutoken_tpu.context import TokenizerContext
from hutoken_tpu.tables import EncoderTables


@dataclass(frozen=True)
class DeviceTables:
    """Packed open-addressed pair table plus the byte LUT and the
    multi-merge bound, as tensors on one device.

    ``pkey[s]`` = ``left << 16 | right`` as an int32 bit pattern (-1 =
    empty), ``pval[s]`` = ``rank << 16 | merged``; slot = mix hash &
    ``cap_mask``, linear probing up to ``probe_len`` slots
    (``hutoken_tpu/tables.py`` ``PairTable.packed_arrays``).
    """

    pkey: torch.Tensor  # int32 [C]
    pval: torch.Tensor  # int32 [C]
    probe_len: int
    cap_mask: int
    byte_seed: Optional[torch.Tensor]  # int32 [256]; None outside byte mode
    minsuper: Optional[torch.Tensor]  # int32 [max_rank + 1]; None = single merges

    @property
    def device(self) -> torch.device:
        return self.pkey.device


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
    """Move ``enc``'s packed pair table, byte LUT and (byte mode only)
    the minsuper bound to ``device``."""
    pt = enc.pair_table
    if not pt.packed_ok:
        raise NotImplementedError(
            "pair ids or ranks do not fit 16 bits; the big-vocab fallbacks "
            "are ROADMAP queue 1 item 7 and not yet ported"
        )
    device = torch.device(device)
    pkey, pval = pt.packed_arrays()
    byte_seed = minsuper = None
    if enc.byte_seed_ids is not None:
        byte_seed = torch.from_numpy(enc.byte_seed_ids.astype(np.int32)).to(device)
        ms = build_minsuper(enc.pairs, ctx.vocab.id2str)
        if ms is not None:
            minsuper = torch.from_numpy(ms).to(device)
    return DeviceTables(
        pkey=torch.from_numpy(pkey).to(device),
        pval=torch.from_numpy(pval).to(device),
        probe_len=pt.probe_len,
        cap_mask=pt.capacity - 1,
        byte_seed=byte_seed,
        minsuper=minsuper,
    )
