"""The plain reference: hutoken's byte-level BPE encode in Python.

A frozen copy of what the port's oracle, pre-tokenizer, file formats
and byte maps compute (``hutoken_tpu_torch/{oracle,pretokenize,formats,
bytemaps}.py``), cut to hutoken's default mode: byte-encoder mode, no
prefix, no user pattern.  It reads the same vocabulary files the harness
hands to the port, takes the same options the configuration hands to
``initialize`` (``harness.reference``), and works out every id itself;
it imports nothing of the port, of its JAX original or of ``torch``.
Built with any other option (char mode, a prefix, a pattern) it raises
and names the option: a configuration in another mode names a reference
of its own in this directory.

Semantics (hutoken's ``src/core.c``):

1. the text splits into parser words: ``[ ]?alpha+ | [ ]?digit+ |
   [ ]?other+ | space+ | one character``, where alpha is ASCII letters
   and the 18 Hungarian accented letters;
2. each word's bytes are remapped per byte: the special-chars table by
   the byte, else a byte >= 0x80 becomes the 2-byte UTF-8 spelling of
   that codepoint, else the byte stays;
3. the remapped word splits into one element per UTF-8 character
   (``<0xNN>`` literals whole on the string path), and the adjacent pair
   of lowest rank merges, the leftmost at equal rank, until no pair has
   a rank.  With a merges.txt a pair's rank is its rule's line index
   among the rules whose three spellings are in the vocabulary; without
   one it is the vocabulary id of the concatenation;
4. the ids are the vocabulary ids of the surviving elements (-1 where
   absent).

:class:`Reference` keeps a word memo of its own.  ``rank_shift=8``
builds the control: the same merge with every rank kept to 8 fewer
bits (``rank >> 8``: 32,458 rules in 7 bits), so pairs
within 256 ranks of each other tie and the leftmost wins, the step
that would tempt a kernel short of key bits and that breaks the
lowest-rank-first order.
"""

from __future__ import annotations

import re

_INF = 0x7FFFFFFF

_ALPHA = "A-Za-z" + "áéíóúőűüöÁÉÍÓÚŐÜŰÖ"
_WS = " \t\n\x0b\x0c\r"
WORD_SPLIT_RE = re.compile(
    rf" ?[{_ALPHA}]+| ?[0-9]+| ?[^{_WS}0-9{_ALPHA}]+| +|.", re.DOTALL
)


def hex_str_to_bytes(hex_str: str) -> bytes:
    """``0xNN0xNN..`` -> bytes; every ``0x`` takes the two characters
    after it, anything else is skipped."""
    out = bytearray()
    i, n = 0, len(hex_str)
    while i < n:
        if hex_str[i] == "0" and i + 1 < n and hex_str[i + 1] == "x":
            i += 2
            if i + 1 < n:
                try:
                    out.append(int(hex_str[i : i + 2], 16))
                except ValueError:
                    pass
            i += 2
        else:
            i += 1
    return bytes(out)


def parse_vocab(path: str) -> dict[bytes, int]:
    """Token bytes -> id; the last line of a spelling wins."""
    str2id: dict[bytes, int] = {}
    with open(path, encoding="utf-8", errors="surrogateescape") as f:
        for line in f:
            sep = line.find(" == ")
            if sep < 0:
                raise ValueError(f"bad vocab line: {line!r}")
            token = hex_str_to_bytes(line[:sep])
            nul = token.find(b"\x00")
            str2id[token if nul < 0 else token[:nul]] = int(line[sep + 4 :].strip())
    return str2id


def parse_special(path: str) -> dict[int, bytes]:
    """Byte -> replacement bytes."""
    table: dict[int, bytes] = {}
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", errors="surrogateescape")
            sep = line.find(" == ")
            index = int(line[:sep].strip())
            value = line[sep + 4 :].rstrip("\n").rstrip("\r")
            if index < 256:
                table[index] = value.encode("utf-8", errors="surrogateescape")
    return table


def parse_merges(path: str, str2id: dict[bytes, int]) -> dict:
    """(left id, right id) -> (rank, merged id); a line whose left,
    right or joined spelling is not in the vocabulary takes no rank."""
    rules: dict[tuple[int, int], tuple[int, int]] = {}
    rank = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", errors="surrogateescape")
            if line.startswith("#"):
                continue
            parts = [p for p in line.rstrip("\r\n").split(" ") if p]
            if len(parts) < 2:
                continue
            lb = parts[0].encode("utf-8", errors="surrogateescape")
            rb = parts[1].encode("utf-8", errors="surrogateescape")
            left, right, merged = str2id.get(lb), str2id.get(rb), str2id.get(lb + rb)
            if left is None or right is None or merged is None:
                continue
            rules[(left, right)] = (rank, merged)
            rank += 1
    return rules


def utf8_len(b: int) -> int:
    if b < 0x80:
        return 1
    if b & 0xE0 == 0xC0:
        return 2
    if b & 0xF0 == 0xE0:
        return 3
    if b & 0xF8 == 0xF0:
        return 4
    return 1


def hex_literal_len(data: bytes, pos: int) -> int:
    """Length of a ``<0x[hex]*>`` literal at ``pos``, else -1."""
    n = len(data)
    if pos + 3 > n or data[pos] != 0x3C or data[pos + 1] != 0x30 or data[pos + 2] not in (0x78, 0x58):
        return -1
    p = pos + 3
    while p < n and chr(data[p]) in "0123456789abcdefABCDEF":
        p += 1
    return p - pos + 1 if p < n and data[p] == 0x3E else -1


def greedy(elems: list, rank_of, join) -> list:
    """Merge the adjacent pair of lowest rank, the leftmost at equal
    rank, until none has a rank.  ``rank_of(a, b)`` is the pair's rank
    or ``_INF``; ``join(a, b)`` the merged element."""
    elems = list(elems)
    while len(elems) > 1:
        ranks = [rank_of(elems[i], elems[i + 1]) for i in range(len(elems) - 1)]
        best = min(ranks)
        if best >= _INF:
            break
        i = ranks.index(best)
        elems[i : i + 2] = [join(elems[i], elems[i + 1])]
    return elems


class Reference:
    """Encode documents with the configuration's files.  The keywords are
    the facade's options for a vocabulary file; ``token_id``, as the
    facade takes it, changes nothing."""

    def __init__(self, vocab: str, special: str, merges: str | None = None,
                 rank_shift: int = 0, *, is_byte_encoder: bool = True,
                 prefix: str | None = None, pattern: str | None = None,
                 token_id: int | None = None):
        other = [] if is_byte_encoder else [f"is_byte_encoder={is_byte_encoder!r}"]
        other += [f"{name}={value!r}" for name, value in (("prefix", prefix), ("pattern", pattern))
                  if value]
        if other:
            raise ValueError(
                f"bpe:Reference computes byte-encoder mode with no prefix and no pattern, "
                f"not {', '.join(other)}: name a reference of its own for this mode")
        self.str2id = parse_vocab(vocab)
        self.special = parse_special(special)
        self.rules = parse_merges(merges, self.str2id) if merges else None
        if self.rules is not None and not self.rules:
            self.rules = None  # a merges file with no valid rule counts as none
        self.rank_shift = rank_shift
        self._memo: dict[str, list[int]] = {}

    def remap(self, word: bytes) -> bytes:
        out = bytearray()
        for b in word:
            repl = self.special.get(b)
            if repl is not None:
                out += repl
            elif b >= 0x80:
                out.append(0xC0 | (b >> 6))
                out.append(0x80 | (b & 0x3F))
            else:
                out.append(b)
        return bytes(out)

    def encode_word(self, word: str) -> list[int]:
        got = self._memo.get(word)
        if got is not None:
            return got
        enc = self.remap(word.encode("utf-8"))
        str2id = self.str2id
        shift = self.rank_shift
        if self.rules is not None:
            rules = self.rules
            seeds, i = [], 0
            while i < len(enc):
                ln = utf8_len(enc[i])
                seeds.append(str2id.get(enc[i : i + ln], -1))
                i += ln

            def rank_of(a, b):
                r = rules.get((a, b))
                return r[0] >> shift if r is not None else _INF

            ids = greedy(seeds, rank_of, lambda a, b: rules[(a, b)][1])
        else:
            elems, i = [], 0
            while i < len(enc):
                ln = hex_literal_len(enc, i)
                if ln <= 0:
                    ln = utf8_len(enc[i])
                elems.append(enc[i : i + ln])
                i += ln
            def rank_of(a, b):
                r = str2id.get(a + b)
                return r >> shift if r is not None else _INF

            merged = greedy(elems, rank_of, lambda a, b: a + b)
            ids = [str2id.get(e, -1) for e in merged]
        self._memo[word] = ids
        return ids

    def encode(self, text: str) -> list[int]:
        if "\x00" in text:
            raise ValueError("embedded null character")
        out: list[int] = []
        for w in WORD_SPLIT_RE.findall(text):
            if w:
                out.extend(self.encode_word(w))
        return out
