"""Shared inputs for the PyTorch port's parity tests: the committed
fixture configurations, the generated wide (100,256-id) fixture
(``hutoken_tpu_torch.corpora.write_wide_fixture``, which the smoke
run writes too),
seeded word blocks, and the JAX package's packed-table tuple built from
the same numpy tables.  Imports no JAX at module level."""

from __future__ import annotations

import functools

import numpy as np

import fixture_tools as ft
from hutoken_tpu.context import TokenizerContext
from hutoken_tpu.tables import build_encoder_tables
from hutoken_tpu_torch.corpora import WIDE_VOCAB_SIZE, write_wide_fixture  # noqa: F401

BYTE_CONFIGS = ("small", "big-vocab", "big-merges")
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))


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
