"""File formats: hex vocab files, special-char files, merges.txt.

The port's own copy of ``hutoken_tpu/formats.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

The on-disk formats are identical to the reference library so existing
assets interoperate:

* **Vocab file** — one token per line, ``0xAA0xBB.. == <id>``
  (parser: reference src/lib.c:243-388, writer: src/helper.c:130-191,
  hutoken.py:65-73).
* **Special chars file** — ``<byte index> == <replacement string>`` lines
  (parser: reference src/lib.c:460-571, writer: hutoken.py:88-101).
* **merges.txt** — ``<left> <right>`` per line, ``#`` comments skipped,
  rank = running index over valid lines (parser: reference src/lib.c:573-663).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field

from .utils.logging import log_debug


class VocabFormatError(ValueError):
    pass


def hex_str_to_bytes(hex_str: str) -> bytes:
    """Decode the ``0xNN0xNN..`` token spelling.

    Mirrors the tolerant scanner in the reference (src/helper.c:82-128):
    every ``0x`` introduces exactly two hex chars; any other character is
    skipped; an incomplete trailing pair is dropped.
    """
    out = bytearray()
    i = 0
    n = len(hex_str)
    while i < n:
        if hex_str[i] == "0" and i + 1 < n and hex_str[i + 1] == "x":
            i += 2
            if i + 1 < n and hex_str[i] != "" :
                pair = hex_str[i : i + 2]
                try:
                    out.append(int(pair, 16))
                except ValueError:
                    pass
            i += 2
        else:
            i += 1
    return bytes(out)


def bytes_to_hex_str(data: bytes) -> str:
    """Encode token bytes in the vocab-file spelling (src/helper.c:175-181)."""
    if not data:
        return "0x00"
    return "".join(f"0x{b:02X}" for b in data)


@dataclass
class Vocab:
    """A parsed vocab file.

    ``str2id`` maps token *bytes* to id with last-line-wins semantics (the
    reference stores tokens in a hashmap keyed by the decoded C string, so a
    duplicate spelling overwrites the earlier id: src/lib.c:370-372).
    ``id2str`` maps id -> token bytes (the decode table, src/lib.c:422-448).
    ``size`` is the number of vocab *lines*, which is what the reference
    uses as ``vocab_size_decode`` for decode bounds checks
    (src/lib.c:254,377, src/core.c:520-529).
    """

    str2id: dict[bytes, int] = field(default_factory=dict)
    id2str: dict[int, bytes] = field(default_factory=dict)
    size: int = 0

    def max_token_len(self) -> int:
        return max((len(s) for s in self.id2str.values()), default=0)


def parse_vocab_file(path: str) -> Vocab:
    """Parse a hex vocab file with the reference's validation behavior.

    Error messages match the reference so downstream error-path tests agree
    (src/lib.c:243-388).
    """
    if not os.path.isfile(path):
        raise FileNotFoundError("Could not open vocab file.")

    vocab = Vocab()
    with open(path, "r", encoding="utf-8", errors="surrogateescape") as f:
        for raw_line in f:
            line = raw_line
            if line == "":
                break
            sep = line.find(" == ")
            if sep == -1:
                log_debug("Error: Invalid format in vocab file: %s", line)
                raise VocabFormatError("Invalid format in vocab file.")
            hex_part = line[:sep]
            value_str = line[sep + 4 :].strip()
            try:
                value = int(value_str)
            except ValueError:
                raise VocabFormatError(
                    "Invalid vocab format: could not parse integer value."
                )
            if value > 2**31 - 1 or value < -(2**31):
                raise VocabFormatError("Integer value in vocab file is out of range.")
            token = hex_str_to_bytes(hex_part)
            # The reference stores tokens as C strings, so a token that
            # *starts* with NUL reads as empty and errors out, and interior
            # NULs truncate the token (src/lib.c:341-357 via strdup).  One
            # usability exception: the trainer's save_vocab spells the empty
            # (byte-0) seed token as exactly "0x00" (src/helper.c:175-177),
            # which the reference then cannot reload; we accept it as the
            # empty token so trained vocabs round-trip.
            if token == b"\x00":
                token = b""
            elif not token or token[0] == 0:
                raise VocabFormatError("Failed to convert hex string to ASCII.")
            nul = token.find(b"\x00")
            if nul != -1:
                token = token[:nul]
            vocab.str2id[token] = value
            vocab.size += 1

    if vocab.size == 0:
        raise VocabFormatError("Vocab file is empty.")

    # Decode table: iterate surviving (deduplicated) entries (src/lib.c:422-448).
    for token, value in vocab.str2id.items():
        vocab.id2str[value] = token
    return vocab


def write_vocab_file(path: str, id2str: dict[int, bytes]) -> None:
    """Write a vocab file sorted by id (format of src/helper.c:171-182)."""
    with open(path, "w", encoding="utf-8") as f:
        for value in sorted(id2str):
            f.write(f"{bytes_to_hex_str(id2str[value])} == {value}\n")


def parse_special_chars_file(path: str) -> dict[int, bytes]:
    """Parse a special-chars file: ``<byte> == <replacement>`` lines.

    Matches reference validation (src/lib.c:460-571): the index must parse
    as an integer in [0, 256]; the replacement is the rest of the line.
    """
    if not os.path.isfile(path):
        raise FileNotFoundError("Could not open special characters file.")

    table: dict[int, bytes] = {}
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", errors="surrogateescape")
            sep = line.find(" == ")
            if sep == -1:
                raise VocabFormatError("Invalid format in special character file.")
            idx_str = line[:sep]
            try:
                index = int(idx_str.strip() or "x")
            except ValueError:
                raise VocabFormatError(
                    "Invalid vocab format: could not parse integer value."
                )
            if index > 256 or index < 0:
                raise VocabFormatError("Integer value in vocab file is out of range.")
            value = line[sep + 4 :]
            if value.endswith("\n"):
                value = value[:-1]
            if value.endswith("\r"):
                value = value[:-1]
            if value == "":
                raise VocabFormatError("Failed to convert hex string to ASCII.")
            if index < 256:
                table[index] = value.encode("utf-8", errors="surrogateescape")
    return table


def write_special_chars_file(path: str, table: dict[int, str | bytes]) -> None:
    """Write a special chars file (format of hutoken.py:88-97)."""
    with open(path, "w", encoding="utf-8") as f:
        for index in sorted(table):
            value = table[index]
            if isinstance(value, bytes):
                value = value.decode("utf-8")
            f.write(f"{index} == {value}\n")


@dataclass
class MergeRules:
    """merges.txt rules resolved against a vocab.

    ``rules`` maps ``(left_id, right_id) -> (rank, merged_id)``; rank is the
    running index over valid, resolvable lines (src/lib.c:604-652).
    """

    rules: dict[tuple[int, int], tuple[int, int]] = field(default_factory=dict)
    num_rules: int = 0


def parse_merges_file(path: str, vocab: Vocab) -> MergeRules | None:
    """Parse merges.txt against ``vocab``.

    Lines starting with ``#`` are skipped; lines without a space are
    skipped; rules whose left/right/merged spelling is not in the vocab are
    skipped without consuming a rank...  Note the reference *increments* the
    rank for every line with both tokens present but only counts resolvable
    rules (src/lib.c:607-652: ``rank++`` happens inside rule construction,
    after the unknown-token check `continue`s, so skipped lines do NOT
    consume a rank).  Returns None if no valid rules exist
    (src/lib.c:593,655-657 leaves merges_map NULL).
    """
    if not os.path.isfile(path):
        raise FileNotFoundError("Could not open merges file.")

    merges = MergeRules()
    rank = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.decode("utf-8", errors="surrogateescape")
            if line.startswith("#"):
                continue
            line = line.rstrip("\r\n")
            # strtok collapses runs of the delimiter, so filter empties.
            parts = [p for p in line.split(" ") if p]
            if len(parts) < 2:
                continue
            left_str = parts[0].encode("utf-8", errors="surrogateescape")
            right_str = parts[1].encode("utf-8", errors="surrogateescape")
            left = vocab.str2id.get(left_str)
            right = vocab.str2id.get(right_str)
            merged = vocab.str2id.get(left_str + right_str)
            if left is None or right is None or merged is None:
                log_debug(
                    "Skipping merge rule with unknown token(s): '%s' + '%s'",
                    parts[0],
                    parts[1],
                )
                continue
            merges.rules[(left, right)] = (rank, merged)
            rank += 1
    merges.num_rules = len(merges.rules)
    if merges.num_rules == 0:
        return None
    return merges
