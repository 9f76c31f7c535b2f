"""Generated inputs of the port's smoke run (``chip_smoke.py``) and of
its CPU parity tests: the fixture corpus text, the JAX bench's two
benchmark corpora, a byte-level vocabulary of 100,256 ids (token ids and
pair ranks past 16 bits) and a SentencePiece-style char-mode vocabulary
of 32,000 ids, written on demand.

Copies of ``tests/fixture_tools.py``'s base text and corpus and of
``bench.py``'s corpus builders, which load the JAX package;
``tests/test_torch_host.py`` holds each equal to its original.  Imports
neither ``torch`` nor ``jax``."""

from __future__ import annotations

import os
import random
import string

import numpy as np

WIDE_VOCAB_SIZE = 100256  # cl100k_base's id count
CHAR_VOCAB_SIZE = 32000  # Llama 2's SentencePiece id count
SPACE_MARK = "\u2581"  # "▁", SentencePiece's space
# the char-mode special-chars file: space and the whitespace controls
CHAR_SPECIALS = {32: SPACE_MARK, 10: "<0x0A>", 13: "<0x0D>", 9: "<0x09>"}
# the lowest rank of the hand-built wide rules: rank * 128 + position
# passes 31 bits from here on
HIGH_RANK = 1 << 24
MAX_RULE_RANK = (1 << 26) - 1  # tables.MAX_WIDE_RANK

BASE_TEXT = (
    "A gyors barna róka átugrik a lusta kutya fölött. "
    "Az őszi szél végigsöpört a Duna-parton, és a fák levelei "
    "aranyszínűre váltak. Öt szűk ütközőpont maradt a hídon. "
    "The quick brown fox jumps over the lazy dog. "
    "Programming languages map bytes to tokens with byte pair encoding. "
    "Számítógépes nyelvészet: a tokenizálás a szöveg feldolgozásának "
    "első lépése. Különböző írásrendszerek — például a kínai 中文 vagy "
    "az emoji 🙂 — bájtsorozatokként jelennek meg. "
    "Egy, kettő, három, négy, öt, hat, hét, nyolc, kilenc, tíz. "
    "1234567890 42 2026 3.14159 0xFF. "
    "   multiple   spaces\tand\nnewlines\r\nare whitespace too. "
    "Árvíztűrő tükörfúrógép. ÁRVÍZTŰRŐ TÜKÖRFÚRÓGÉP. "
)


def make_corpus() -> str:
    """Seeded word-shuffled expansions of the base text."""
    rng = random.Random(42)
    words = BASE_TEXT.split(" ")
    parts = [BASE_TEXT]
    for _ in range(12):
        sample = [rng.choice(words) for _ in range(len(words))]
        parts.append(" ".join(sample))
    return " ".join(parts)


CORPUS = make_corpus()


def build_corpus(target_mb: float, seed: int = 0) -> list[str]:
    """The Zipf-like corpus: frequent base words mixed with rare forms."""
    rng = random.Random(seed)
    base_words = CORPUS.split()
    forms = set(base_words)
    for w in list(base_words):
        for _ in range(30):
            forms.add(w + rng.choice(string.ascii_lowercase))
            forms.add(
                w
                + rng.choice(string.ascii_lowercase)
                + rng.choice(string.ascii_lowercase)
            )
    forms = sorted(forms)  # set order varies per process (hash seed)
    nrng = np.random.default_rng(seed)
    base_arr = np.array(base_words)
    forms_arr = np.array(forms)
    docs: list[str] = []
    total = 0
    target = int(target_mb * 1e6)
    est_doc = 256 * 7
    while total < target:
        n_docs = max((target - total) // est_doc, 1)
        picks = nrng.random((n_docs, 256)) < 0.7
        wb = base_arr[nrng.integers(0, len(base_arr), (n_docs, 256))]
        wf = forms_arr[nrng.integers(0, len(forms_arr), (n_docs, 256))]
        words = np.where(picks, wb, wf)
        for row in words:
            doc = " ".join(row.tolist())
            docs.append(doc)
            total += len(doc.encode())
            if total >= target:
                break
    return docs


def build_unique_corpus(target_mb: float, seed: int = 1) -> list[str]:
    """The high-entropy corpus: random identifiers, numbers, URL-ish
    fragments and long-tail inflections, nearly every word first-seen."""
    nrng = np.random.default_rng(seed)
    hu_suffix = (
        "aink eink aitok eitek aik eik unk ünk tok tek nak nek ban ben "
        "ból ből hoz hez val vel".split()
    )
    docs: list[str] = []
    total = 0
    target = int(target_mb * 1e6)
    while total < target:
        n_words = 256 * 64
        kinds = nrng.integers(0, 4, n_words)
        lens = nrng.integers(3, 13, n_words)
        body_len = np.where(
            kinds == 1, np.maximum(lens - 4, 2),
            np.where(kinds == 2, np.maximum(lens - 4, 3),
                     np.where(kinds == 3, np.maximum(lens - 3, 2), lens)),
        )
        maxl = int(body_len.max())
        chars = np.where(
            (kinds == 1)[:, None],
            nrng.integers(ord("0"), ord("9") + 1, (n_words, maxl)),
            nrng.integers(ord("a"), ord("z") + 1, (n_words, maxl)),
        ).astype(np.uint8)
        bodies = [
            row[:bl].tobytes().decode()
            for row, bl in zip(chars, body_len)
        ]
        sfx = nrng.integers(0, len(hu_suffix), n_words)
        words = [
            b if k == 0 or k == 1 else (b + ".io/" if k == 2 else b + hu_suffix[s])
            for b, k, s in zip(bodies, kinds, sfx)
        ]
        for lo in range(0, n_words, 256):
            doc = " ".join(words[lo : lo + 256])
            docs.append(doc)
            total += len(doc.encode())
            if total >= target:
                break
    return docs


def _wide_tokens() -> dict[bytes, int]:
    """Raw token bytes -> id: the 256 byte seeds, then breadth-first
    prefix chains (with and without the leading space) over about 60,000
    word forms, the base words plus 2-4 random lowercase letters.  Every
    multi-byte token splits into in-vocab halves, as in a trained BPE
    vocabulary; ids follow creation order."""
    rng = random.Random(11)
    base_words = sorted(set(BASE_TEXT.split()))
    forms = list(base_words)
    while len(forms) < 60000:
        tail = "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(2, 4)))
        forms.append(rng.choice(base_words) + tail)
    tokens = {bytes([i]): i for i in range(256)}
    for ln in range(2, 32):
        for w in forms:
            wb = (" " + w).encode("utf-8")
            for cand in (wb[:ln], wb[1 : 1 + ln]):
                if len(cand) == ln and cand not in tokens:
                    tokens[cand] = len(tokens)
                    if len(tokens) == WIDE_VOCAB_SIZE:
                        return tokens
    raise ValueError(f"the word forms give only {len(tokens)} tokens")


def write_wide_fixture(directory: str) -> tuple[str, str, str]:
    """Write a byte-level vocabulary of ``WIDE_VOCAB_SIZE`` ids (token
    ids and pair ranks past 16 bits), spelled as GPT-2 spells it, its
    special-chars file and a merges.txt (rule ``(t[:-1], t[-1])`` for
    every token whose parent is in the vocab, in id order) into
    ``directory``; returns the three paths.  Deterministic."""
    from .bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table
    from .formats import write_special_chars_file

    os.makedirs(directory, exist_ok=True)
    vocab_path = os.path.join(directory, "wide-vocab.txt")
    special_path = os.path.join(directory, "wide-vocab_special_chars.txt")
    merges_path = os.path.join(directory, "wide-merges.txt")
    b2u = gpt2_bytes_to_unicode()
    spelled = [
        "".join(b2u[b] for b in tok)
        for tok, _idx in sorted(_wide_tokens().items(), key=lambda kv: kv[1])
    ]
    with open(vocab_path, "w", encoding="utf-8") as f:
        for idx, sp in enumerate(spelled):
            hex_token = "".join(f"0x{b:02X}" for b in sp.encode("utf-8"))
            f.write(f"{hex_token} == {idx}\n")
    write_special_chars_file(special_path, gpt2_special_chars_table())
    known = set(spelled)
    with open(merges_path, "w", encoding="utf-8") as f:
        f.write("#version: fixture-wide\n")
        for idx, sp in enumerate(spelled):
            if idx >= 256 and len(sp) >= 2 and sp[:-1] in known:
                f.write(f"{sp[:-1]} {sp[-1]}\n")
    return vocab_path, special_path, merges_path


def _char_tokens() -> list[str]:
    """Char-mode tokens in id order: the 256 ``<0xNN>`` byte fallbacks,
    "▁", the printable ASCII characters and every other character of
    ``BASE_TEXT`` but whitespace, then breadth-first prefix chains of
    characters over about 60,000 word forms (the base words plus 2-4
    random lowercase letters), each with and without a leading "▁".
    Every multi-character token splits into an in-vocab prefix and its
    last character."""
    rng = random.Random(13)
    tokens = [f"<0x{b:02X}>" for b in range(256)] + [SPACE_MARK]
    chars = sorted(set(BASE_TEXT) | {chr(c) for c in range(0x21, 0x7F)})
    tokens += [c for c in chars if not c.isspace()]
    known = set(tokens)
    base_words = sorted(set(BASE_TEXT.split()))
    forms = list(base_words)
    while len(forms) < 60000:
        tail = "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(2, 4)))
        forms.append(rng.choice(base_words) + tail)
    for ln in range(2, 64):
        for w in forms:
            for cand in ((SPACE_MARK + w)[:ln], w[:ln]):
                if len(cand) == ln and cand not in known:
                    known.add(cand)
                    tokens.append(cand)
                    if len(tokens) == CHAR_VOCAB_SIZE:
                        return tokens
    raise ValueError(f"the word forms give only {len(tokens)} tokens")


def write_char_fixture(directory: str) -> tuple[str, str]:
    """Write a SentencePiece-style char-mode vocabulary of
    ``CHAR_VOCAB_SIZE`` ids (every id below 0xFFFF, so the pair table is
    the narrow one) and its special-chars file (space to "▁", newline,
    carriage return and tab to their ``<0xNN>`` fallbacks) into
    ``directory``; returns the two paths.  It has no merges file: its
    pair rules are every split of a token into two tokens, ranked by
    id.  Load it with ``is_byte_encoder=False``.  Deterministic."""
    from .formats import write_special_chars_file

    os.makedirs(directory, exist_ok=True)
    vocab_path = os.path.join(directory, "char-vocab.txt")
    special_path = os.path.join(directory, "char-vocab_special_chars.txt")
    with open(vocab_path, "w", encoding="utf-8") as f:
        for idx, tok in enumerate(_char_tokens()):
            hex_token = "".join(f"0x{b:02X}" for b in tok.encode("utf-8"))
            f.write(f"{hex_token} == {idx}\n")
    write_special_chars_file(special_path, CHAR_SPECIALS)
    return vocab_path, special_path


def high_rank_rules(seed: int = 0, n_base: int = 48):
    """Hand-built merge rules for the wide pair table, with every rank in
    ``HIGH_RANK .. MAX_RULE_RANK`` and merged ids from 0x10000: rules over
    pairs of the base ids ``0 .. n_base - 1``, rules joining their
    results to a base id on either side, and one marker rule, ids
    ``(n_base, n_base + 1)``, with the lowest rank of all.  Returns
    ``(pairs {(left, right): (rank, merged)}, marker)``.  Deterministic
    (numpy, ``seed``)."""
    rng = np.random.default_rng(seed)
    firsts = [(a, b) for a in range(n_base) for b in range(n_base) if rng.random() < 0.3]
    merged = 0x10000
    pairs = {}
    for a, b in firsts:
        pairs[(a, b)] = merged
        merged += 1
    level1 = list(pairs.values())
    while len(pairs) < 2 * len(firsts):
        m, x = int(level1[rng.integers(len(level1))]), int(rng.integers(n_base))
        key = (m, x) if rng.random() < 0.5 else (x, m)
        if key not in pairs:
            pairs[key] = merged
            merged += 1
    ranks = np.unique(rng.integers(HIGH_RANK + 1, MAX_RULE_RANK + 1, 4 * len(pairs)))
    ranks = rng.permutation(ranks)[: len(pairs)]
    rules = {k: (int(r), int(m)) for (k, m), r in zip(pairs.items(), ranks)}
    marker = (n_base, n_base + 1)
    rules[marker] = (HIGH_RANK, merged)
    return rules, marker


def high_rank_block(rules_marker, W: int, L: int, seed: int = 0) -> np.ndarray:
    """int32 ``[W, L]`` rows of base ids of :func:`high_rank_rules`, full
    length, each with the marker pair at a position of 32 or more, so
    that every row's first minimum lies past the first 32 positions.
    ``L`` is at least 34."""
    rng = np.random.default_rng(seed)
    _rules, (ma, mb) = rules_marker
    block = rng.integers(0, ma, (W, L)).astype(np.int32)
    at = rng.integers(32, L - 1, W)
    block[np.arange(W), at] = ma
    block[np.arange(W), at + 1] = mb
    return block
