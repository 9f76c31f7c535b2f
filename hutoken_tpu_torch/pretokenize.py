"""Pre-tokenization: word splitting and byte/char remapping.

The port's own copy of ``hutoken_tpu/pretokenize.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Reproduces the reference's two pre-tokenization stages:

1. **Word splitting** — the hand-rolled parser (reference: src/parser.c)
   with its exact character classes and priority order:
   ``[ ]?alpha+`` | ``[ ]?digit+`` | ``[ ]?other+`` | ``space+`` |
   single byte, where *alpha* is ASCII letters plus the 18 Hungarian
   accented codepoints (src/parser.c:102-129), *digit* is ASCII 0-9, *other*
   is any codepoint that is none of the above and not C-locale whitespace
   (src/parser.c:135-142), and the optional leading character is a single
   0x20 space.  An explicit POSIX extended regex can override the parser
   (src/core.c:352-359); we compile it with Python's ``re`` after a
   POSIX-class translation.

2. **Remapping** (``pretokenizer_encode``, src/pretokenizer.c:30-100): per
   byte (byte-encoder mode) or per UTF-8 char, replace via the 256-entry
   special-chars table indexed by the first byte; otherwise in byte mode
   expand bytes >= 0x80 to the 2-byte UTF-8 spelling of codepoint==byte;
   otherwise copy.  An optional prefix is prepended *unremapped*.
"""

from __future__ import annotations

import re
from typing import Iterator

# The 18 Hungarian accented codepoints + ASCII letters (src/parser.c:102-129).
HUNGARIAN_ACCENTS = "áéíóúőűüöÁÉÍÓÚŐÜŰÖ"
_ALPHA = "A-Za-z" + HUNGARIAN_ACCENTS
# C-locale isspace for cp <= 255 (src/parser.c:140-142).
_WS = " \t\n\x0b\x0c\r"

# Single-pass regex equivalent of parser_next_token's priority cascade
# (src/parser.c:24-88).  Documented-equivalent pattern: tests/test_parser.c:10-12.
WORD_SPLIT_RE = re.compile(
    rf" ?[{_ALPHA}]+"
    rf"| ?[0-9]+"
    rf"| ?[^{_WS}0-9{_ALPHA}]+"
    rf"| +"
    rf"|.",
    re.DOTALL,
)


def split_words(text: str) -> list[str]:
    """Split ``text`` into parser words (fast regex path).

    Equivalent to repeatedly calling ``parser_next_token``
    (src/parser.c:24-88) on valid UTF-8 input; asserted against
    :func:`split_words_scalar` by the golden-master test, mirroring the
    reference's own parser-vs-regex oracle test (tests/test_parser.c:77-108).
    """
    return WORD_SPLIT_RE.findall(text)


def _is_custom_alpha(cp: int) -> bool:
    if (0x61 <= cp <= 0x7A) or (0x41 <= cp <= 0x5A):
        return True
    return chr(cp) in HUNGARIAN_ACCENTS


def _is_digit(cp: int) -> bool:
    return 0x30 <= cp <= 0x39


def _is_whitespace(cp: int) -> bool:
    return cp <= 255 and chr(cp) in _WS


def _is_other(cp: int) -> bool:
    return (
        cp != 0
        and not _is_whitespace(cp)
        and not _is_custom_alpha(cp)
        and not _is_digit(cp)
    )


def split_words_scalar(text: str) -> list[str]:
    """Direct scalar port of the parser state machine (src/parser.c:24-88).

    Used as the oracle for the regex fast path.
    """
    out: list[str] = []
    n = len(text)
    pos = 0
    while pos < n:
        # Each class may consume one optional leading space.
        matched = False
        for pred in (_is_custom_alpha, _is_digit, _is_other):
            s = pos
            if text[s] == " ":
                s += 1
            e = s
            while e < n and pred(ord(text[e])):
                e += 1
            if e > s:
                out.append(text[pos:e])
                pos = e
                matched = True
                break
        if matched:
            continue
        if text[pos] == " ":
            e = pos + 1
            while e < n and text[e] == " ":
                e += 1
            out.append(text[pos:e])
            pos = e
            continue
        out.append(text[pos])
        pos += 1
    return out


_POSIX_CLASSES = {
    "[:alpha:]": "A-Za-z",
    "[:digit:]": "0-9",
    "[:space:]": _WS,
    "[:alnum:]": "A-Za-z0-9",
    "[:upper:]": "A-Z",
    "[:lower:]": "a-z",
    "[:punct:]": re.escape("!\"#$%&'()*+,-./:;<=>?@[\\]^_`{|}~"),
    "[:xdigit:]": "0-9A-Fa-f",
}


def compile_user_pattern(pattern: str) -> "re.Pattern[str]":
    """Compile a user-supplied POSIX extended regex with Python ``re``.

    The reference hands the pattern to ``regcomp(REG_EXTENDED)``
    (src/core.c:352-359).  POSIX character classes are translated; the
    pattern is otherwise assumed to be in the common subset of POSIX ERE
    and Python syntax.  Raises ValueError with the reference's message on
    a bad pattern.
    """
    translated = pattern
    for posix, py in _POSIX_CLASSES.items():
        translated = translated.replace(posix, py)
    try:
        return re.compile(translated)
    except re.error as e:
        raise ValueError("Regex could not be compiled.") from e


def split_words_pattern(text: str, compiled: "re.Pattern[str]") -> Iterator[str]:
    """Split using a user regex the way the reference's encode loop does.

    ``regexec`` is called repeatedly from the cursor; the *gap* before a
    match is skipped; a zero-length match advances the cursor by one byte
    (src/core.c:368-400).
    """
    pos = 0
    n = len(text)
    while pos < n:
        m = compiled.search(text, pos)
        if m is None:
            break
        if m.start() == m.end():
            pos = m.start() + 1
            continue
        yield m.group(0)
        pos = m.end()


def encode_remap(
    word: bytes,
    special_chars: dict[int, bytes],
    prefix: bytes | None,
    is_byte_encoder: bool,
) -> bytes:
    """``pretokenizer_encode`` (src/pretokenizer.c:30-100) on raw bytes.

    Scans per byte (byte mode) or per UTF-8 char; the replacement table is
    indexed by the *first byte* either way (src/pretokenizer.c:56).
    """
    out = bytearray()
    if prefix:
        out += prefix
    i = 0
    n = len(word)
    while i < n:
        b = word[i]
        if is_byte_encoder:
            char_len = 1
        else:
            char_len = _u8len(b)
        repl = special_chars.get(b)
        if repl is not None:
            out += repl
        elif is_byte_encoder and b >= 0x80:
            out.append(0xC0 | (b >> 6))
            out.append(0x80 | (b & 0x3F))
        else:
            out += word[i : i + char_len]
        i += char_len
    return bytes(out)


def _u8len(first_byte: int) -> int:
    if first_byte & 0x80 == 0x00:
        return 1
    if first_byte & 0xE0 == 0xC0:
        return 2
    if first_byte & 0xF0 == 0xE0:
        return 3
    if first_byte & 0xF8 == 0xF0:
        return 4
    return 1
