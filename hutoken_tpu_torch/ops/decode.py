"""Device decode in PyTorch: token ids -> decoded text bytes (port of
``hutoken_tpu/ops/decode.py``).

The engine reverse-remaps every token's spelling once into a
``[V, ld]`` byte table, flattened to ``dec_flat``; decode is then data
movement: per-token v-deltas scattered at token starts, one cumsum, one
table gather per output byte.  For output byte i owned by token j,
``v[j] + i = ids[j] * ld + (i - offs[j])`` is row j's byte in the flat
table, and ``v`` of every byte is the cumsum of the deltas.  Tokens that
share a start (zero-length decoded spellings) telescope: their deltas
add up at that start and the sum is the last one's ``v``.

These functions are plain PyTorch on whatever device their tensors live
on; there is no kernel and no twin.  ``fast_gather`` of the reference
(``ops/merge.py:43``) works around XLA's slow gather fusion on the TPU
and is plain indexing here.

Three traps of the port, each marked where it is met: ``.at[].add(mode=
"drop")`` drops out-of-range pad entries where ``index_add_`` would
raise, ``torch.cumsum`` of int32 widens to int64 unless told otherwise,
and uint16 token streams travel as int16 bit patterns.
"""

from __future__ import annotations

import torch


def _scatter_v(offs: torch.Tensor, delta: torch.Tensor, keep: torch.Tensor,
               out_size: int) -> torch.Tensor:
    """``zeros(out_size).at[offs].add(delta, mode="drop")`` then cumsum,
    as int32.  ``index_add_`` raises on an out-of-range index, so the
    pad entries (``keep`` False, or offs >= out_size) are masked out
    first; tokens sharing a start still all add."""
    keep = keep & (offs >= 0) & (offs < out_size)
    acc = torch.zeros(out_size, dtype=torch.int32, device=offs.device)
    acc.index_add_(0, offs[keep].to(torch.int64), delta[keep].to(torch.int32))
    # int32 cumsum: torch widens an int32 cumsum to int64 unless dtype says
    # otherwise; the reference's is int32 (and so wraps the same way)
    return torch.cumsum(acc, 0, dtype=torch.int32)


def _gather_bytes(dec_flat: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``dec_flat[clip(v + arange, 0, len - 1)]``: the output blob."""
    idx = v + torch.arange(v.shape[0], dtype=torch.int32, device=v.device)
    idx = idx.clamp(0, dec_flat.shape[0] - 1)
    return dec_flat[idx.to(torch.int64)]


def _token_prep(counts: torch.Tensor, toks: torch.Tensor, n_valid: int, ld: int):
    """Per-token lengths, their inclusive int32 cumsum, the v-deltas and
    the valid mask of a padded token stream."""
    ids = toks.to(torch.int32)
    if toks.dtype == torch.int16:
        # a uint16 stream travels as int16 bit patterns (torch's uint16
        # lacks most ops): widen, then drop the sign extension
        ids = ids & 0xFFFF
    N = ids.shape[0]
    valid = torch.arange(N, device=ids.device) < n_valid
    lens = torch.where(valid, counts[ids.to(torch.int64)], 0).to(torch.int32)
    cum = torch.cumsum(lens, 0, dtype=torch.int32)
    offs = cum - lens
    v = ids * ld - offs
    vprev = torch.cat([torch.zeros(1, dtype=torch.int32, device=v.device), v[:-1]])
    delta = torch.where(valid, v - vprev, 0)
    return cum, offs, delta, valid


def decode_tokens_blob(dec_flat: torch.Tensor, counts: torch.Tensor,
                       toks: torch.Tensor, n_valid: int, out_size: int,
                       ld: int) -> torch.Tensor:
    """Decode from raw token ids: the length gather, the offset cumsum
    and the v-deltas run on the device too, so the host uploads only the
    token stream.  ``counts`` int32 [V] decoded bytes per id; ``toks``
    [N] int32 ids, or uint16 ids as int16 bit patterns, with ``n_valid``
    real entries; ``ld`` the table's row stride.  Returns uint8
    [out_size]; bytes past the real total are padding for the caller to
    slice off.  Every call adds one to ``decode_tokens_blob.calls``."""
    decode_tokens_blob.calls += 1
    _cum, offs, delta, valid = _token_prep(counts, toks, n_valid, ld)
    return _gather_bytes(dec_flat, _scatter_v(offs, delta, valid, out_size))


decode_tokens_blob.calls = 0


def decode_tokens_blob_tot(dec_flat: torch.Tensor, counts: torch.Tensor,
                           toks: torch.Tensor, n_valid: int,
                           doc_local: torch.Tensor, out_size: int,
                           ld: int) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`decode_tokens_blob` plus ``aux`` int32 [1 + Dq]: ``aux[0]``
    the chunk's real byte total (the caller checks it against
    ``out_size`` afterwards) and ``aux[1:]`` the byte offsets of the
    document boundaries in ``doc_local`` (token indices local to the
    chunk, 0-padded; a boundary at 0 is byte 0).  Every call adds one to
    ``decode_tokens_blob_tot.calls``."""
    decode_tokens_blob_tot.calls += 1
    cum, offs, delta, valid = _token_prep(counts, toks, n_valid, ld)
    blob = _gather_bytes(dec_flat, _scatter_v(offs, delta, valid, out_size))
    dl = doc_local.to(torch.int64)
    docb = torch.where(dl > 0, cum[(dl - 1).clamp(min=0)], 0)
    aux = torch.cat([cum[-1:], docb.to(torch.int32)])
    return blob, aux


decode_tokens_blob_tot.calls = 0


def write_chunk(out: torch.Tensor, chunk: torch.Tensor, offset: int) -> torch.Tensor:
    """Write ``chunk`` into ``out`` at byte ``offset``, in place (the
    reference donates ``out``), and return ``out``.  Like
    ``dynamic_update_slice``, a negative offset counts from the end and
    the offset is then clamped so that the chunk fits; slice assignment
    alone would do neither."""
    if chunk.shape[0] > out.shape[0]:
        raise ValueError(f"chunk of {chunk.shape[0]} bytes exceeds out of {out.shape[0]}")
    off = int(offset)
    if off < 0:
        off += out.shape[0]
    off = min(max(off, 0), out.shape[0] - chunk.shape[0])
    out[off : off + chunk.shape[0]] = chunk
    return out
