"""Shared inputs for the PyTorch port's parity tests: the committed
fixture configurations, the generated wide (100,256-id) fixture, seeded
word blocks, and the JAX package's packed-table tuple built from the
same numpy tables.  Imports no JAX at module level: ``chip_smoke.py``
uses :func:`write_wide_fixture` too."""

from __future__ import annotations

import functools
import os
import random
import string

import numpy as np

import fixture_tools as ft
from hutoken_tpu.bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table
from hutoken_tpu.context import TokenizerContext
from hutoken_tpu.formats import write_special_chars_file
from hutoken_tpu.tables import build_encoder_tables

BYTE_CONFIGS = ("small", "big-vocab", "big-merges")
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))
WIDE_VOCAB_SIZE = 100256  # cl100k_base's id count


def _wide_tokens() -> dict[bytes, int]:
    """Raw token bytes -> id: the 256 byte seeds, then breadth-first
    prefix chains (with and without the leading space) over about 60,000
    word forms, the fixture base words plus 2-4 random lowercase
    letters.  Every multi-byte token splits into in-vocab halves, as in
    a trained BPE vocabulary; ids follow creation order."""
    rng = random.Random(11)
    base_words = sorted(set(ft._BASE_TEXT.split()))
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
    special-chars file and a merges.txt built as
    ``fixture_tools.write_big_merges_fixture`` builds one (rule
    ``(t[:-1], t[-1])`` for every token whose parent is in the vocab, in
    id order) into ``directory``; returns the three paths.
    Deterministic."""
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


@functools.lru_cache(maxsize=None)
def load(name: str):
    """(TokenizerContext, EncoderTables) of a fixture configuration:
    ``small`` (768-id byte-level vocab), ``big-vocab`` (23,096 ids, string
    path), ``big-merges`` (the same vocab with merges.txt) and
    ``charmode`` (SentencePiece-style, prefix gluing)."""
    if name == "small":
        v, s = ft.write_byte_level_fixture()
        ctx = TokenizerContext.load(v, s, is_byte_encoder=True)
    elif name == "charmode":
        v, s = ft.write_char_mode_fixture()
        ctx = TokenizerContext.load(v, s, prefix="▁", is_byte_encoder=False)
    else:
        v, s = ft.write_big_vocab_fixture()
        m = ft.write_big_merges_fixture() if name == "big-merges" else None
        ctx = TokenizerContext.load(v, s, is_byte_encoder=True, merges_file_path=m)
    return ctx, build_encoder_tables(ctx)


@functools.lru_cache(maxsize=None)
def device_tables_cpu(name: str):
    from hutoken_tpu_torch.tables import device_tables

    ctx, enc = load(name)
    return device_tables(enc, ctx, "cpu")


def jax_packed_table(enc):
    """The JAX engine's MODE_PACKED table tuple over ``enc``'s pair table."""
    import jax.numpy as jnp

    from hutoken_tpu.ops.merge import MODE_PACKED

    pt = enc.pair_table
    pkey, pval = pt.packed_arrays()
    zero = jnp.zeros(1, jnp.int32)
    return (
        jnp.asarray(pkey), jnp.asarray(pval), zero, zero,
        pt.probe_len, pt.capacity - 1, MODE_PACKED,
    )


def corpus_words() -> list[bytes]:
    """Distinct words of the fixture corpus, bare and with a leading
    space (the split keeps the space on the word)."""
    words = sorted({w.encode() for w in ft.CORPUS.split()})
    return words + [b" " + w for w in words]


def word_block(rng, W: int, width: int, lo: int = 0, charset: bytes | None = None):
    """uint8 [W, width] rows + int32 lens in [lo, width]: about half the
    rows are corpus words cut to their length (these merge), the rest
    random strings over ``charset`` (letters and space by default)."""
    letters = np.frombuffer(charset or b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    lens = rng.integers(lo, width + 1, W).astype(np.int32)
    raw = letters[rng.integers(0, len(letters), (W, width))]
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    words = [w for w in corpus_words() if lo <= len(w) <= width]
    if words:
        for i in np.flatnonzero(rng.random(W) < 0.5):
            w = words[rng.integers(0, len(words))]
            raw[i] = 0
            raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
            lens[i] = len(w)
    return raw, lens


def long_word_block(rng, W: int, width: int, lo: int):
    """Rows of ``lo``..``width`` bytes made by gluing corpus words
    (spaces removed), so long words still merge."""
    pool = b"".join(w.strip() for w in corpus_words())
    lens = rng.integers(lo, width + 1, W).astype(np.int32)
    raw = np.zeros((W, width), dtype=np.uint8)
    for i in range(W):
        st = int(rng.integers(0, len(pool) - width))
        raw[i, : lens[i]] = np.frombuffer(pool[st : st + lens[i]], dtype=np.uint8)
    return raw, lens


def unpack(packed: np.ndarray, W: int) -> list[list[int]]:
    """Per-word token lists from the packed layout (counts, then tokens)."""
    counts = packed[:W].astype(np.int64) & 0x7FFF
    starts = W + np.concatenate(([0], np.cumsum(counts)[:-1]))
    return [packed[s : s + c].astype(np.int64).tolist() for s, c in zip(starts, counts)]
