"""The JAX engine's path tests, mirrored on the port: ``tests/
test_engine.py``, ``test_fuzz_crossengine.py``, ``test_adversarial_vocabs.py``
and ``test_edge_paths.py``, each case against the port's scalar oracle
and native engine, and against the JAX engine where the original compares
engines.  Every engine case runs under ``HUTOKEN_TPU_RAW=0`` (the word
pipeline) and ``=1`` (the raw path, where the configuration allows it).
Contexts are built twice from the same inputs, with the port's classes
and with the JAX package's, so that the port runs on nothing of the JAX
package.  Token ids are integers: every comparison is exact.

Blocks are cut to a few dozen rows, as in ``test_torch_engine.py``, so
that small batches reach the device path (the twins of the kernels)
rather than the host tail."""

import functools
import random
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
import hutoken_tpu.bytemaps as J_bytemaps  # noqa: E402
import hutoken_tpu.context as J_context  # noqa: E402
import hutoken_tpu.formats as J_formats  # noqa: E402
from hutoken_tpu import oracle as J_oracle  # noqa: E402
from hutoken_tpu_torch import bytemaps as P_bytemaps  # noqa: E402
from hutoken_tpu_torch import context as P_context  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import formats as P_formats  # noqa: E402
from hutoken_tpu_torch import oracle  # noqa: E402
from hutoken_tpu_torch.native import NativeEngine, load_native  # noqa: E402

torch.set_num_threads(1)
RAW = ["0", "1"]

PORT = types.SimpleNamespace(ctx=P_context.TokenizerContext, vocab=P_formats.Vocab,
                             bytemaps=P_bytemaps)
JAX = types.SimpleNamespace(ctx=J_context.TokenizerContext, vocab=J_formats.Vocab,
                            bytemaps=J_bytemaps)


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


@pytest.fixture(params=RAW, ids=[f"raw{r}" for r in RAW])
def raw(request, monkeypatch):
    monkeypatch.setenv("HUTOKEN_TPU_RAW", request.param)
    return request.param


def _engine(ctx):
    return E.TorchTokenizer(ctx, device="cpu")


def _jax_engine(ctx):
    from hutoken_tpu.engine import TpuTokenizer

    return TpuTokenizer(ctx)


def _fixture_ctx(pkg, merges=False, **kw):
    v, s = ft.write_byte_level_fixture()
    m = {"merges_file_path": ft.write_merges_fixture()} if merges else {}
    return pkg.ctx.load(v, s, is_byte_encoder=True, **m, **kw)


def _vocab(pkg, toks: dict[bytes, int], size=None):
    return pkg.vocab(str2id=dict(toks), id2str={v: k for k, v in toks.items()},
                     size=size if size is not None else max(toks.values()) + 1)


def _agree(ctx, jctx, texts, roundtrip=True, threads=2, jax_engine=None):
    """The port's engine == its oracle == its native engine == the JAX
    engine (``jax_engine``, or one built on ``jctx``) on ``texts``; with
    ``roundtrip``, the port's engine decodes the ids back to the texts."""
    want = [oracle.encode(ctx, t) for t in texts]
    engine = _engine(ctx)
    assert engine.encode_batch(texts) == want, "port engine diverged"
    if load_native() is not None:
        assert NativeEngine(ctx).encode_batch(texts, threads) == want, "native engine diverged"
    jax_engine = jax_engine or _jax_engine(jctx)
    assert jax_engine.encode_batch(texts) == want, "JAX engine diverged"
    if roundtrip:
        assert engine.decode_batch(want) == texts
    return want


# --------------------------------------------------- tests/test_engine.py

TEXTS = [
    "A gyors barna róka átugrik a lusta kutya fölött.",
    " The quick brown fox jumps over the lazy dog.",
    "Öt szűk ütközőpont: 0xFF, 3.14159.",
    "   multiple   spaces\tand\nnewlines\r\nare whitespace too.",
    "emoji 🙂 and 中文 chars",
    "\n\nTest\n",
    "",
    " ",
    "x",
]


@pytest.fixture(scope="module")
def byte_ctx():
    return _fixture_ctx(PORT)


@pytest.fixture(scope="module")
def jax_byte_ctx():
    return _fixture_ctx(JAX)


def test_engine_matches_oracle(raw, byte_ctx, jax_byte_ctx):
    engine = _engine(byte_ctx)
    got = engine.encode_batch(TEXTS)
    assert got == [oracle.encode(byte_ctx, t) for t in TEXTS]
    assert got == _jax_engine(jax_byte_ctx).encode_batch(TEXTS)
    assert (engine._raw_enc is not None) == (raw == "1")  # the path the setting names


def test_engine_decode_matches_oracle(raw, byte_ctx):
    token_lists = [oracle.encode(byte_ctx, t) for t in TEXTS if t]
    got = _engine(byte_ctx).decode_batch(token_lists)
    assert got == [oracle.decode(byte_ctx, ids) for ids in token_lists]
    assert got == [t for t in TEXTS if t]


def test_engine_corpus(raw, byte_ctx):
    engine = _engine(byte_ctx)
    got = engine.encode_batch([ft.CORPUS])
    assert got == [oracle.encode(byte_ctx, ft.CORPUS)]
    assert engine.decode_batch(got) == [ft.CORPUS]


def test_engine_fuzz(raw, byte_ctx):
    rng = random.Random(99)
    words = ft.CORPUS.split()
    batch = []
    for _ in range(200):
        n = rng.randrange(0, 10)
        text = " ".join(rng.choice(words) for _ in range(n))
        if rng.random() < 0.3:
            text = " " + text
        batch.append(text)
    got = _engine(byte_ctx).encode_batch(batch)
    for g, t in zip(got, batch):
        assert g == oracle.encode(byte_ctx, t), repr(t)


def test_engine_merges_path(raw):
    ctx, jctx = _fixture_ctx(PORT, merges=True), _fixture_ctx(JAX, merges=True)
    got = _engine(ctx).encode_batch(TEXTS)
    assert got == [oracle.encode(ctx, t) for t in TEXTS]
    assert got == _jax_engine(jctx).encode_batch(TEXTS)


def test_engine_prefix_path(raw):
    """SentencePiece-style prefix handling through the engine (never the
    raw path, whatever HUTOKEN_TPU_RAW says)."""
    toks = {b"_": 0, b"a": 1, b"b": 2, b"_a": 3, b"ab": 4, b"_ab": 5, b"_b": 6}
    ctx, jctx = (pkg.ctx(vocab=_vocab(pkg, toks), prefix=b"_", special_chars={32: b"_"})
                 for pkg in (PORT, JAX))
    texts = ["ab", " ab", "ab ab", "b", " b a"]
    got = _engine(ctx).encode_batch(texts)
    assert got == [oracle.encode(ctx, t) for t in texts]
    assert got == _jax_engine(jctx).encode_batch(texts)


def test_probe_table_lookup():
    """The original probes with the JAX package's numpy probe, which the
    port has no copy of; the port probes its device table (wide: ranks
    pass 16 bits) with ``ops/merge.py::probe_pairs``."""
    from hutoken_tpu_torch.ops.merge import INF_RANK, probe_pairs
    from hutoken_tpu_torch.tables import build_pair_table, device_tables

    rng = random.Random(5)
    pairs = {}
    for _ in range(5000):
        a, b = rng.randrange(0, 50000), rng.randrange(0, 50000)
        pairs[(a, b)] = (rng.randrange(0, 1 << 20), rng.randrange(0, 1 << 20))
    enc = types.SimpleNamespace(pair_table=build_pair_table(pairs), pairs=pairs, byte_seed_ids=None)
    tab = device_tables(enc, None, "cpu")
    keys = list(pairs)
    a = torch.tensor([k[0] for k in keys], dtype=torch.int32)
    b = torch.tensor([k[1] for k in keys], dtype=torch.int32)
    rank, merged = probe_pairs(tab, a, b)
    assert list(zip(rank.tolist(), merged.tolist())) == [pairs[k] for k in keys]
    # misses
    r2, m2 = probe_pairs(tab, torch.tensor([60001, 70002], dtype=torch.int32),
                         torch.tensor([1, 2], dtype=torch.int32))
    assert (r2 == INF_RANK).all() and (m2 == -1).all()


# ------------------------------------------ tests/test_fuzz_crossengine.py


def _random_byte_level_ctxs(rng: random.Random):
    """A small vocab trained (by the port's trainer) on random-ish text,
    spelled GPT-2 style; (port context, JAX context, words)."""
    from hutoken_tpu_torch.train.bbpe import bbpe_train_core

    words = []
    alphabet = "abcdefghijklmnopqrstuvwxyzáéíóúőűüö0123456789.,!?"
    for _ in range(rng.randrange(20, 60)):
        n = rng.randrange(1, 9)
        words.append("".join(rng.choice(alphabet) for _ in range(n)))
    corpus = " ".join(rng.choice(words) for _ in range(800))
    str2id = bbpe_train_core(corpus.encode("utf-8"), rng.randrange(280, 500), verbose=False)
    ctxs = []
    for pkg in (PORT, JAX):
        b2u = pkg.bytemaps.gpt2_bytes_to_unicode()
        spelled2id = {"".join(b2u[b] for b in (t if t else b"\x00")).encode("utf-8"): i
                      for t, i in str2id.items()}
        sc = {k: v.encode("utf-8") for k, v in pkg.bytemaps.gpt2_special_chars_table().items()}
        ctxs.append(pkg.ctx(vocab=_vocab(pkg, spelled2id), special_chars=sc, is_byte_encoder=True))
    return ctxs[0], ctxs[1], words


def _random_texts(rng: random.Random, words: list[str], n: int) -> list[str]:
    texts = []
    for _ in range(n):
        k = rng.randrange(0, 14)
        t = " ".join(rng.choice(words) for _ in range(k))
        roll = rng.random()
        if roll < 0.2:
            t = " " + t
        elif roll < 0.3:
            t = t + "  "
        elif roll < 0.4:
            t = t.replace(" ", "\n", 1)
        texts.append(t)
    return texts


@pytest.mark.parametrize("seed", range(8))
def test_cross_engine_agreement(raw, seed):
    rng = random.Random(1000 + seed)
    ctx, jctx, words = _random_byte_level_ctxs(rng)
    texts = _random_texts(rng, words, 40)
    want = [oracle.encode(ctx, t) for t in texts]
    assert want == [J_oracle.encode(jctx, t) for t in texts]
    for t, ids in zip(texts, want):
        assert oracle.decode(ctx, ids) == t
    if load_native() is not None:
        ne = NativeEngine(ctx)
        assert ne.encode_batch(texts, 4) == want
        assert ne.decode_batch([w for w in want if w], 2) == [t for t, w in zip(texts, want) if w]
    eng = _engine(ctx)
    assert eng.encode_batch(texts) == want
    assert eng.decode_batch([w for w in want if w]) == [t for t, w in zip(texts, want) if w]
    assert _jax_engine(jctx).encode_batch(texts) == want


# ---------------------------------------- tests/test_adversarial_vocabs.py


def _byte_level_ctxs(extra_tokens: dict[bytes, int]):
    """GPT-2-spelled byte seeds + extra raw-byte tokens at given ids;
    (port context, JAX context)."""
    ctxs = []
    for pkg in (PORT, JAX):
        b2u = pkg.bytemaps.gpt2_bytes_to_unicode()

        def spell(raw_bytes: bytes) -> bytes:
            return "".join(b2u[b] for b in raw_bytes).encode("utf-8")

        str2id = {spell(bytes([b])): b for b in range(256)}
        for raw_bytes, tid in extra_tokens.items():
            str2id[spell(raw_bytes)] = tid
        sc = {k: v.encode("utf-8") for k, v in pkg.bytemaps.gpt2_special_chars_table().items()}
        ctxs.append(pkg.ctx(vocab=_vocab(pkg, str2id), special_chars=sc, is_byte_encoder=True))
    return ctxs


def _chains(bases, nid=300) -> dict[bytes, int]:
    """Prefix chains: every prefix of 2 bytes or more of each base, new
    ids from ``nid`` on."""
    extra: dict[bytes, int] = {}
    for base in bases:
        for ln in range(2, len(base) + 1):
            if base[:ln] not in extra:
                extra[base[:ln]] = nid
                nid += 1
    return extra


def test_special_token_spellings(raw):
    """GPT-2-style control tokens: long, punctuation-heavy spellings
    built from pair chains so the greedy loop can reach them."""
    extra = _chains([t.encode() for t in ("<|endoftext|>", "<|fim_prefix|>", "<|pad|>", "</s>", "<s>")])
    texts = ["<|endoftext|>", "hello<|endoftext|>world", "<|fim_prefix|>x<|pad|></s>",
             "<<|endoftext|", "<|< |>< s>"]
    _agree(*_byte_level_ctxs(extra), texts)


@functools.lru_cache(maxsize=None)
def _long_chain_setup():
    """The contexts of test_very_long_tokens and the JAX engine on them,
    built once for both HUTOKEN_TPU_RAW settings (the JAX engine reads
    the setting per call; its table build takes about 20 s)."""
    ctx, jctx = _byte_level_ctxs(_chains([b"a" * 80, b"b" * 600]))
    return ctx, jctx, _jax_engine(jctx)


def test_very_long_tokens(raw):
    """Tokens longer than the 32-byte kernel words and the native
    StrMap's 512-byte stack buffer; the witness of the port's
    minutes-long table build (its minsuper bound): the port's engine
    must build in under 10 s."""
    import time

    ctx, jctx, jax_engine = _long_chain_setup()
    t0 = time.perf_counter()
    _engine(ctx)
    assert time.perf_counter() - t0 < 10.0
    texts = ["a" * 80, "a" * 79 + "c", "b" * 600, "b" * 601, ("a" * 80 + " ") * 3]
    _agree(ctx, jctx, texts, jax_engine=jax_engine)


def test_hex_literal_dense_vocab(raw):
    """Char-mode vocab where <0xNN> byte-fallback literals dominate."""
    toks: dict[bytes, int] = {b"": 0}
    nid = 1
    for b in range(0x00, 0x20):
        toks[f"<0x{b:02X}>".encode()] = nid
        nid += 1
    for ch in "abcdefgh ":
        toks[ch.encode()] = nid
        nid += 1
    for s in (b"ab", b"abc", b"<0x0A>a", b"a<0x0A>", b"<0x0A><0x0D>"):
        toks[s] = nid
        nid += 1
    ctx, jctx = (pkg.ctx(vocab=_vocab(pkg, toks, size=nid),
                         special_chars={0x0A: b"<0x0A>", 0x0D: b"<0x0D>"}, is_byte_encoder=False)
                 for pkg in (PORT, JAX))
    texts = ["ab\ncd", "a\n", "\na", "\n\r", "abc abc", "h\rg"]
    _agree(ctx, jctx, texts, roundtrip=False)


def test_probe_clustering_pairs(raw):
    """Thousands of pairs sharing one left id (hash clustering pressure
    on the open-addressed pair table)."""
    rng = random.Random(4)
    seen: list[bytes] = []
    for _ in range(3000):
        w = "".join(rng.choice("abcdefgh") for _ in range(rng.randrange(2, 6)))
        seen.append(b" " + w.encode())
    extra = _chains(seen)
    words = [k[1:].decode() for k in list(extra)[:200] if len(k) > 3]
    texts = [" ".join(rng.choice(words) for _ in range(rng.randrange(1, 12))) for _ in range(30)]
    _agree(*_byte_level_ctxs(extra), texts)


def test_cross_engine_fuzz_over_adversarial(raw):
    """The three-engine fuzz over a mixed adversarial vocab."""
    rng = random.Random(77)
    extra = _chains([b"<|eot|>", b"z" * 70, b" qu", b"\xc3\xa1rv\xc3\xadz"])
    atoms = ["<|eot|>", "z" * 70, "qu", "árvíz", " ", "\t", "x", "<|", "|>"]
    texts = ["".join(rng.choice(atoms) for _ in range(rng.randrange(0, 12))) for _ in range(60)]
    _agree(*_byte_level_ctxs(extra), texts)


# ----------------------------------------------- tests/test_edge_paths.py


def test_long_words_cross_buckets(raw, byte_ctx, jax_byte_ctx):
    texts = ["x" * 31, "x" * 32, "x" * 33, "y" * 127, "y" * 128, "z" * 129, "w" * 4000,
             "a " + "q" * 200 + " b"]
    engine = _engine(byte_ctx)
    got = engine.encode_batch(texts)
    assert got == [oracle.encode(byte_ctx, t) for t in texts]
    assert got == _jax_engine(jax_byte_ctx).encode_batch(texts)
    assert engine.decode_batch(got) == texts


def test_long_words_native(byte_ctx):
    if load_native() is None:
        pytest.skip("native library not built")
    texts = ["x" * 600, "á" * 300, "🙂" * 80, ("ab" * 200 + " ") * 3]
    assert NativeEngine(byte_ctx).encode_batch(texts, 2) == [oracle.encode(byte_ctx, t) for t in texts]


def test_all_bytes_roundtrip(raw, byte_ctx):
    """Every non-NUL byte value through encode + decode (byte mode), in
    the oracle and the port's engine."""
    text = "".join(chr(c) for c in range(1, 256))
    ids = oracle.encode(byte_ctx, text)
    assert all(i >= 0 for i in ids)
    assert oracle.decode(byte_ctx, ids) == text
    engine = _engine(byte_ctx)
    assert engine.encode_batch([text]) == [ids]
    assert engine.decode_batch([ids]) == [text]


def test_mixed_whitespace_forms(byte_ctx):
    enc = ft.tiktoken_encoding()
    for t in ["\t\t  \n \r\n\x0b\x0c", "a\tb\nc d", "   \t   ", "\n\n\n"]:
        assert oracle.encode(byte_ctx, t) == enc.encode(t), repr(t)
        assert oracle.decode(byte_ctx, oracle.encode(byte_ctx, t)) == t


def test_unknown_seed_chars_fall_back_exactly(raw):
    """Char-mode vocab missing some chars: -1 ids, in every engine."""
    toks = {b"a": 0, b"b": 1, b"ab": 2, b" ": 3}
    ctx, jctx = (pkg.ctx(vocab=_vocab(pkg, toks, size=len(toks))) for pkg in (PORT, JAX))
    texts = ["ab", "aXb", "é ab", "abXXab"]
    want = _agree(ctx, jctx, texts, roundtrip=False)
    assert want[1] == [0, -1, 1]


def test_custom_regex_pattern_paths(raw):
    """A user-supplied POSIX pattern: gaps between matches are skipped
    (never the raw path)."""
    ctx = _fixture_ctx(PORT, pattern="[a-zA-Z]+|[0-9]+")
    jctx = _fixture_ctx(JAX, pattern="[a-zA-Z]+|[0-9]+")
    texts = ["hello world 42", "  gaps!! are## skipped 7x", "", "123abc"]
    want = [oracle.encode(ctx, t) for t in texts]
    assert oracle.decode(ctx, want[1]) == "gapsareskipped7x"
    got = _engine(ctx).encode_batch(texts)
    assert got == want and got == _jax_engine(jctx).encode_batch(texts)
    assert np.array_equal(np.concatenate([np.asarray(w, dtype=np.int64) for w in want]),
                          np.concatenate([np.asarray(g, dtype=np.int64) for g in got]))
