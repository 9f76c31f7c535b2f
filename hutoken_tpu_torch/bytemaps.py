"""Byte <-> unicode remapping tables.

The port's own copy of ``hutoken_tpu/bytemaps.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

The reference implements GPT-2-style byte-level pre-tokenization as a
256-entry replacement table plus an inline 2-byte UTF-8 expansion for bytes
>= 0x80 (reference: src/pretokenizer.c:54-83).  Combined with the special
character table that the facade generates from a Hugging Face
``byte_encoder`` (reference: hutoken.py:88-101), this reproduces the
standard GPT-2 ``bytes_to_unicode`` mapping.

This module provides that mapping natively so that fixture/special-char
files can be generated offline, and so the device engine can build dense
byte -> initial-token-id gather tables.
"""

from __future__ import annotations

from functools import lru_cache

# Bytes the GPT-2 tokenizer remaps to codepoints >= 256.  Mirrors
# ``_SPECIAL_CHARS`` in the reference facade (reference: hutoken.py:15-20).
SPECIAL_CHAR_BYTES: list[int] = list(range(33)) + [127] + list(range(128, 161)) + [173]


@lru_cache(maxsize=None)
def gpt2_bytes_to_unicode() -> dict[int, str]:
    """The public GPT-2 byte -> unicode-char mapping.

    Printable latin-1 bytes map to themselves; the rest map to
    codepoints 256+n in order.  This is the composition of the reference's
    special-chars table with its >=0x80 2-byte expansion
    (reference: src/pretokenizer.c:56-73, hutoken.py:91-92).
    """
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@lru_cache(maxsize=None)
def gpt2_unicode_to_bytes() -> dict[str, int]:
    return {v: k for k, v in gpt2_bytes_to_unicode().items()}


def gpt2_special_chars_table() -> dict[int, str]:
    """The special-chars table hutoken's facade would write for GPT-2.

    Only bytes that GPT-2 encodes *differently* get an entry
    (reference: hutoken.py:88-97); byte values >= 0x80 not present here
    are handled by the inline 2-byte expansion in byte-encoder mode.
    """
    b2u = gpt2_bytes_to_unicode()
    return {b: b2u[b] for b in SPECIAL_CHAR_BYTES}


def utf8_char_length(first_byte: int) -> int:
    """UTF-8 sequence length from the first byte (reference: src/pretokenizer.c:14-28)."""
    if first_byte & 0x80 == 0x00:
        return 1
    if first_byte & 0xE0 == 0xC0:
        return 2
    if first_byte & 0xF0 == 0xE0:
        return 3
    if first_byte & 0xF8 == 0xF0:
        return 4
    return 1


def hex_token_length(data: bytes, pos: int = 0) -> int:
    """Length of a literal ``<0xNN..>`` run starting at ``pos``, else -1.

    Matches the reference's byte-fallback-literal detection used when seeding
    string-path BPE elements (reference: src/core.c:35-47): ``<0x`` followed
    by any number (including zero) of hex digits, closed by ``>``.
    """
    n = len(data)
    if pos + 3 > n or data[pos] != 0x3C:  # '<'
        return -1
    if data[pos + 1] != 0x30 or data[pos + 2] not in (0x78, 0x58):  # '0', 'x'/'X'
        return -1
    p = pos + 3
    while p < n and chr(data[p]) in "0123456789abcdefABCDEF":
        p += 1
    if p < n and data[p] == 0x3E:  # '>'
        return p - pos + 1
    return -1
