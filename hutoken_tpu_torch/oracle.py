"""Exact scalar encode/decode — the behavioral oracle.

The port's own copy of ``hutoken_tpu/oracle.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

A from-scratch Python implementation of the reference's tokenization
semantics (src/core.c).  It is used three ways:

1. as the differential-testing oracle for the device engine,
2. as the host fallback for inputs the device fast path cannot take
   (words with out-of-vocab seed elements in the string path, or words
   longer than the largest device bucket),
3. as the reference implementation the C++ host engine is tested against.

The greedy merge is implemented as "repeatedly merge the valid adjacent
pair minimizing (rank, left_index)".  This is provably equivalent to the
reference's min-heap with stale-candidate skipping (src/core.c:111-176):
every currently-adjacent pair with a valid rank has a fresh heap entry
(pushed when it became adjacent or re-ranked, src/core.c:150-175), and all
stale entries are filtered by the consumed/adjacency/rank checks
(src/core.c:119-137), so each pop yields exactly the (rank, left_idx)
minimum over current valid pairs — the heap order is (rank asc, left_idx
asc), src/queue.c heapify comparisons.
"""

from __future__ import annotations

from typing import Optional

from .bytemaps import hex_token_length, utf8_char_length
from .context import TokenizerContext
from .pretokenize import encode_remap, split_words, split_words_pattern

_INF = 0x7FFFFFFF


def seed_elements_string_path(encoded_word: bytes) -> list[bytes]:
    """Seed string-path elements: one per UTF-8 char, but literal
    ``<0xNN>`` runs stay whole (src/core.c:49-55, 483-487)."""
    out: list[bytes] = []
    i = 0
    n = len(encoded_word)
    while i < n:
        ln = hex_token_length(encoded_word, i)
        if ln <= 0:
            ln = utf8_char_length(encoded_word[i])
        out.append(encoded_word[i : i + ln])
        i += ln
    return out


def _merge_string_path(
    elements: list[bytes], str2id: dict[bytes, int]
) -> list[int]:
    """Greedy BPE over byte-string elements; rank of a pair is the vocab id
    of the concatenated spelling (src/core.c:700-722); final ids are vocab
    lookups of surviving elements, -1 when absent (src/core.c:196-208)."""
    elems = list(elements)
    if len(elems) > 1:
        ranks = [
            str2id.get(elems[i] + elems[i + 1], _INF) for i in range(len(elems) - 1)
        ]
        while True:
            best_rank = _INF
            best_i = -1
            for i, r in enumerate(ranks):
                if r < best_rank:
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            elems[best_i] = elems[best_i] + elems.pop(best_i + 1)
            ranks.pop(best_i)
            if best_i > 0:
                ranks[best_i - 1] = str2id.get(
                    elems[best_i - 1] + elems[best_i], _INF
                )
            if best_i < len(ranks):
                ranks[best_i] = str2id.get(elems[best_i] + elems[best_i + 1], _INF)
    out = []
    for e in elems:
        v = str2id.get(e)
        out.append(v if v is not None else -1)
    return out


def _merge_id_path(
    ids: list[int], rules: dict[tuple[int, int], tuple[int, int]]
) -> list[int]:
    """Greedy BPE over token ids with explicit merge-rule ranks
    (src/core.c:211-337)."""
    elems = list(ids)
    if len(elems) > 1:
        def rank_of(i: int) -> int:
            r = rules.get((elems[i], elems[i + 1]))
            return r[0] if r is not None else _INF

        ranks = [rank_of(i) for i in range(len(elems) - 1)]
        while True:
            best_rank = _INF
            best_i = -1
            for i, r in enumerate(ranks):
                if r < best_rank:
                    best_rank = r
                    best_i = i
            if best_i < 0:
                break
            _, merged = rules[(elems[best_i], elems[best_i + 1])]
            elems[best_i] = merged
            elems.pop(best_i + 1)
            ranks.pop(best_i)
            if best_i > 0:
                ranks[best_i - 1] = rank_of(best_i - 1)
            if best_i < len(ranks):
                ranks[best_i] = rank_of(best_i)
    return elems


def encode_word(ctx: TokenizerContext, word: bytes, prefix: Optional[bytes]) -> list[int]:
    """Pre-tokenize + BPE one word (src/core.c:448-496)."""
    encoded = encode_remap(word, ctx.special_chars, prefix, ctx.is_byte_encoder)
    if not encoded:
        return []
    if ctx.merges is not None:
        ids: list[int] = []
        i = 0
        n = len(encoded)
        while i < n:
            ln = utf8_char_length(encoded[i])
            v = ctx.vocab.str2id.get(encoded[i : i + ln])
            ids.append(v if v is not None else -1)
            i += ln
        return _merge_id_path(ids, ctx.merges.rules)
    elements = seed_elements_string_path(encoded)
    return _merge_string_path(elements, ctx.vocab.str2id)


def encode(ctx: TokenizerContext, text: str) -> list[int]:
    """Full document encode (src/core.c:339-511).

    Implements the prefix state machine exactly: if the text starts with a
    non-space byte, the prefix is glued onto the first word
    (``add_prefix``); if it starts with a space, the prefix is separately
    remapped+merged and its token run emitted before the first word
    (``add_prefix_token``) (src/core.c:364-366, 421-450).
    """
    if "\x00" in text:
        raise ValueError("embedded null character")
    tokens: list[int] = []
    if ctx.compiled_pattern is not None:
        words = split_words_pattern(text, ctx.compiled_pattern)
    else:
        words = split_words(text)

    add_prefix = not text.startswith(" ")
    add_prefix_token = not add_prefix
    for word in words:
        wb = word.encode("utf-8")
        if not wb:
            continue
        if add_prefix_token and ctx.prefix:
            prefix_encoded = encode_remap(
                ctx.prefix, ctx.special_chars, None, ctx.is_byte_encoder
            )
            prefix_elements = _seed_per_char(prefix_encoded)
            tokens.extend(_merge_string_path(prefix_elements, ctx.vocab.str2id))
            add_prefix_token = False
        tokens.extend(
            encode_word(ctx, wb, ctx.prefix if add_prefix else None)
        )
        add_prefix = False
    return tokens


def _seed_per_char(data: bytes) -> list[bytes]:
    """Per-UTF-8-char seeding with no <0xNN> grouping — used for the
    standalone prefix token run (src/core.c:432-437)."""
    out = []
    i = 0
    while i < len(data):
        ln = utf8_char_length(data[i])
        out.append(data[i : i + ln])
        i += ln
    return out


def decode_bytes(ctx: TokenizerContext, ids: list[int]) -> bytes:
    """ids -> raw concatenated token bytes with bounds checks
    (src/core.c:513-561)."""
    total = []
    for t in ids:
        if t < 0 or t >= ctx.vocab.size:
            raise ValueError("Element must be non-negative and less than vocab size.")
        total.append(ctx.vocab.id2str.get(t, b""))
    return b"".join(total)


def reverse_remap(ctx: TokenizerContext, raw: bytes) -> bytes:
    """``pretokenizer_decode`` (src/pretokenizer.c:197-296): strip prefix,
    then longest-match the special replacement strings back to their
    original byte; in byte mode unmatched chars collapse to their
    codepoint-as-byte (or '?'), in char mode they are copied."""
    if ctx.prefix and raw.startswith(ctx.prefix):
        raw = raw[len(ctx.prefix) :]
    return reverse_remap_nostrip(ctx, raw)


def reverse_remap_nostrip(ctx: TokenizerContext, raw: bytes) -> bytes:
    """The replacement-reversal scan alone (no prefix strip)."""
    # longest-match tables: length -> {pattern: original byte}
    by_len: dict[int, dict[bytes, int]] = {}
    for idx, val in ctx.special_chars.items():
        by_len.setdefault(len(val), {})[val] = idx
    lengths = sorted(by_len, reverse=True)

    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        matched = False
        for ln in lengths:
            if ln <= n - i:
                hit = by_len[ln].get(raw[i : i + ln])
                if hit is not None:
                    out.append(hit)
                    i += ln
                    matched = True
                    break
        if matched:
            continue
        if ctx.is_byte_encoder:
            cp, consumed = _utf8_to_codepoint(raw, i)
            if cp < 256:
                out.append(cp)
            else:
                out.append(ord("?"))
            i += consumed if consumed > 0 else 1
        else:
            ln = utf8_char_length(raw[i])
            out += raw[i : i + ln]
            i += ln
    return bytes(out)


def _utf8_to_codepoint(data: bytes, i: int) -> tuple[int, int]:
    """(codepoint, bytes_read) — src/pretokenizer.c:175-195."""
    b0 = data[i]
    if b0 < 0x80:
        return b0, 1
    if (b0 & 0xE0) == 0xC0 and i + 1 < len(data):
        return ((b0 & 0x1F) << 6) | (data[i + 1] & 0x3F), 2
    if (b0 & 0xF0) == 0xE0 and i + 2 < len(data):
        return ((b0 & 0x0F) << 12) | ((data[i + 1] & 0x3F) << 6) | (
            data[i + 2] & 0x3F
        ), 3
    if (b0 & 0xF8) == 0xF0 and i + 3 < len(data):
        return (
            ((b0 & 0x07) << 18)
            | ((data[i + 1] & 0x3F) << 12)
            | ((data[i + 2] & 0x3F) << 6)
            | (data[i + 3] & 0x3F)
        ), 4
    return 0xFFFD, 1


def decode(ctx: TokenizerContext, ids: list[int]) -> str:
    raw = decode_bytes(ctx, ids)
    return reverse_remap(ctx, raw).decode("utf-8")
