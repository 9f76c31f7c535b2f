"""Vocabularies whose ids or ranks pass 16 bits in the PyTorch port, on
the CPU: the wide pair table and its probe, the fused twin and the eager
fixed point on it, the engine, device decode and the facade, over the
generated 100,256-id fixture (``torch_parity.write_wide_fixture``, string
path and merges.txt path) and a char-mode vocabulary whose ids start
above 0xFFFF.  They are held against the JAX package's ``MODE_PROBE``
probe, its R-matrix programs (``hutoken_tpu/ops/rmatrix.py``), its
engine and facade, the native engine and the scalar oracle.  Token ids
are integers: every comparison is exact."""

import dataclasses
import random
import string

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import fixture_tools as ft  # noqa: E402
import hutoken_tpu as jax_facade  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
import torch_parity as tp  # noqa: E402
from hutoken_tpu import engine as JE  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.context import TokenizerContext  # noqa: E402
from hutoken_tpu.formats import MergeRules, Vocab  # noqa: E402
from hutoken_tpu.native import NativeEngine  # noqa: E402
from hutoken_tpu.ops import merge as JM  # noqa: E402
from hutoken_tpu.tables import build_encoder_tables  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.ops import decode as D  # noqa: E402
from hutoken_tpu_torch.ops import fused_merge as FM  # noqa: E402
from hutoken_tpu_torch.ops import merge as TM  # noqa: E402
from hutoken_tpu_torch.tables import device_tables  # noqa: E402

torch.set_num_threads(1)
CONFIGS = ["string", "merges"]
HIGH = 0x10000  # the first id a 16-bit packed table cannot hold


@pytest.fixture(scope="module")
def wide_files(tmp_path_factory):
    return tp.write_wide_fixture(str(tmp_path_factory.mktemp("wide")))


@pytest.fixture(scope="module")
def wide(wide_files):
    """name -> (ctx, enc, JAX engine, port engine on the CPU), each built
    once.  Both engines are handed the encoder tables already built for
    ``ctx`` (rebuilding them takes seconds and gives the same numbers)."""
    vocab, special, merges = wide_files
    built = {}

    def get(name):
        if name not in built:
            ctx = TokenizerContext.load(
                vocab, special, is_byte_encoder=True,
                merges_file_path=merges if name == "merges" else None,
            )
            enc = build_encoder_tables(ctx)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(JE, "build_encoder_tables", lambda _ctx: enc)
                mp.setattr(E, "build_encoder_tables", lambda _ctx: enc)
                jax_engine = JE.TpuTokenizer(ctx)
                port = E.TorchTokenizer(ctx, device="cpu")
            built[name] = (ctx, enc, jax_engine, port)
        return built[name]

    return get


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _forms(rng, n: int) -> list[str]:
    """Word forms shaped like the ones the wide vocabulary was chained
    over (a fixture base word plus 2-4 lowercase letters): their long
    prefixes are the ids past 16 bits."""
    base = sorted(set(ft._BASE_TEXT.split()))
    return [
        rng.choice(base) + "".join(rng.choice(string.ascii_lowercase) for _ in range(rng.randint(2, 4)))
        for _ in range(n)
    ]


def _word_block(seed: int, W: int, width: int, lo: int = 0):
    """uint8 [W, width] + int32 lens: a third wide forms (with their
    leading space, as the split keeps it), the rest ``tp.word_block``'s
    corpus words and random strings; for widths over 32, glued corpus
    words of ``lo``..``width`` bytes as well."""
    rng = np.random.default_rng(seed)
    if width > 32:
        raw, lens = tp.long_word_block(rng, W, width, lo)
    else:
        raw, lens = tp.word_block(rng, W, width, lo)
    forms = [w for w in (b" " + f.encode() for f in _forms(random.Random(seed), 4 * W)) if len(w) <= width]
    for i in np.flatnonzero(rng.random(W) < 1 / 3):
        w = forms[int(rng.integers(0, len(forms)))]
        if lo <= len(w):
            raw[i] = 0
            raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
            lens[i] = len(w)
    return raw, lens


def _docs(seed: int, n: int = 80) -> list[str]:
    rng = random.Random(seed)
    words = [w.decode() for w in tp.corpus_words()]
    docs = []
    for _ in range(n):
        parts = []
        for _ in range(rng.randint(1, 30)):
            kind = rng.random()
            if kind < 0.4:
                parts.append(rng.choice(words).strip())
            elif kind < 0.8:
                parts.extend(_forms(rng, 1))
            elif kind < 0.95:
                parts.append("".join(rng.choice("abcdefghijklmnopqrstuvwxyzáéőű0123456789")
                                     for _ in range(rng.randint(1, 12))))
            else:  # 33-150 bytes: the eager fixed point, or the host past 128
                parts.append("".join(w.strip() for w in rng.sample(words, 12))[: rng.randint(33, 150)])
        docs.append(" ".join(parts) + rng.choice(["", ".", "!\n", "  \t"]))
    return docs + [ft.CORPUS[:2000], "", " ", "x", " leading space"]


def _max_id(token_lists) -> int:
    return max((max(t) for t in token_lists if t), default=-1)


# ------------------------------------------------------------- the table


@pytest.mark.parametrize("name", CONFIGS)
def test_wide_table_layout(name, wide):
    """The fixture passes 16 bits (the JAX engine takes MODE_PROBE and the
    R-matrix); the port holds the wide table, with no packed keys and no
    minsuper bound, at 8 MB or less."""
    ctx, enc, jax_engine, port = wide(name)
    assert ctx.vocab.size == tp.WIDE_VOCAB_SIZE
    assert not enc.pair_table.packed_ok
    assert jax_engine.table_arrays[-1] == JM.MODE_PROBE
    assert jax_engine._substr_arrays is not None
    assert jax_engine._substr_merges == (name == "merges")
    tab = port.dev_tables
    assert tab.wide and tab.pslots is None
    assert tab.slots.dtype == torch.int32 and tab.slots.shape[1] == 4
    assert tab.slots.numel() * 4 <= 8 << 20
    assert tab.minsuper is None
    assert max(r for r, _m in enc.pairs.values()) >= HIGH


# ------------------------------------------------------------ the probe


@pytest.mark.parametrize("name", CONFIGS)
def test_probe_pairs_wide_matches_jax(name, wide):
    """Real pairs, random ids with PAD, and real pairs whose ids have bit
    16 flipped (equal under 16-bit truncation) against the JAX
    ``probe_pairs`` on the engine's MODE_PROBE table."""
    _ctx, enc, jax_engine, port = wide(name)
    rng = np.random.default_rng(3)
    real = np.array(list(enc.pairs.keys()), dtype=np.int32)
    pick = real[rng.integers(0, len(real), 3000)]
    noise = rng.integers(-1, enc.vocab_size, (2000, 2)).astype(np.int32)
    wide_real = real[(real >= HIGH).any(axis=1)]
    alias = wide_real[rng.integers(0, len(wide_real), 1000)] ^ HIGH
    ab = np.concatenate([pick, noise, alias])
    a, b = ab[:, 0].reshape(60, 100), ab[:, 1].reshape(60, 100)
    want_r, want_m = JM.probe_pairs(jax_engine.table_arrays, jnp.asarray(a), jnp.asarray(b))
    got_r, got_m = TM.probe_pairs_wide(port.dev_tables, torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    hits = got_r.numpy() < TM.INF_RANK
    assert hits.sum() >= 3000 and (got_m.numpy()[hits] >= HIGH).any()
    assert not hits.reshape(-1)[5000:].any()  # no alias resolves to its twin
    # the dispatching probe takes the wide one; the packed one refuses
    r2, m2 = TM.probe_pairs(port.dev_tables, torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(r2, got_r) and torch.equal(m2, got_m)
    with pytest.raises(ValueError, match="no packed keys"):
        TM.probe_pairs_packed(port.dev_tables, torch.from_numpy(a), torch.from_numpy(b))


# ----------------------------------------------------- the fixed points


@pytest.mark.parametrize("name", CONFIGS)
def test_merge_words_packed_matches_jax(name, wide):
    """Id blocks (byte-seeded words and random ids) through the eager
    fixed point against the JAX ``merge_words_packed`` under MODE_PROBE."""
    _ctx, enc, jax_engine, port = wide(name)
    raw, lens = _word_block(7, 192, 32)
    ids = np.where(np.arange(32)[None, :] < lens[:, None], enc.byte_seed_ids[raw], -1)
    rng = np.random.default_rng(8)
    ids[:16] = rng.integers(0, enc.vocab_size, (16, 32))
    ids = ids.astype(np.int32)
    want = np.asarray(JM.merge_words_packed(jax_engine.table_arrays, jnp.asarray(ids), False))
    got = TM.merge_words_packed(port.dev_tables, torch.from_numpy(ids), False).numpy()
    assert got.dtype == want.dtype == np.int32
    assert np.array_equal(got, want)
    assert (got[192:] >= HIGH).any()


def _rmatrix(jax_engine, raw, lens):
    """The JAX engine's byte-block merge for a MODE_PROBE vocabulary:
    ``merge_words_from_bytes_rmatrix`` (string path) or ``_merges``
    (merges path, ``_substr_merges``), with the engine's own span depth
    (``test_wide_table_layout`` checks that it holds the R-matrix)."""
    return np.asarray(jax_engine._merge_bytes_block(raw, lens))


def _assert_oracle(ctx, raw, lens, packed, rows):
    for i, toks in enumerate(tp.unpack(packed, raw.shape[0])[:rows]):
        wb = bytes(raw[i, : lens[i]])
        assert toks == (oracle.encode_word(ctx, wb, None) if lens[i] else []), wb


@pytest.mark.parametrize("width", [8, 16, 32])
@pytest.mark.parametrize("name", CONFIGS)
def test_fused_twin_matches_rmatrix(name, width, wide):
    """Words of up to 32 bytes: the wide kernel's plain twin against the
    R-matrix program the JAX engine runs for them, and the oracle."""
    ctx, _enc, jax_engine, port = wide(name)
    raw, lens = _word_block(10 + width, 256, width)
    lens[:3] = [0, 1, width]
    want = _rmatrix(jax_engine, raw, lens)
    got = FM.merge_words_from_bytes_fused(
        port.dev_tables, torch.from_numpy(raw), torch.from_numpy(lens), False
    ).numpy()
    assert np.array_equal(got, want)
    assert (got[256:] >= HIGH).any() or width == 8
    _assert_oracle(ctx, raw, lens, got, 64)


@pytest.mark.parametrize("width", [64, 128])
@pytest.mark.parametrize("name", CONFIGS)
def test_eager_fixed_point_matches_rmatrix(name, width, wide):
    """Words of 33-128 bytes: the eager wide fixed point against the
    R-matrix program, and the oracle."""
    ctx, _enc, jax_engine, port = wide(name)
    raw, lens = _word_block(20 + width, 48, width, lo=33)
    lens[:2] = [33, width]
    want = _rmatrix(jax_engine, raw, lens)
    got = TM.merge_words_from_bytes_packed(
        port.dev_tables, torch.from_numpy(raw), torch.from_numpy(lens), False
    ).numpy()
    assert np.array_equal(got, want)
    assert (got[48:] >= HIGH).any()
    _assert_oracle(ctx, raw, lens, got, 16)


def test_fused_twin_single_merge_rounds_equal_with_a_minsuper_bound():
    """A wide table can carry a minsuper bound (ids past 16 bits, ranks
    below): multi-merge rounds reach the single-merge fixed point."""
    enc, ctx = _shifted_byte_vocab()
    tab = device_tables(enc, ctx, "cpu")
    assert tab.wide and tab.minsuper is not None
    raw, lens = tp.word_block(np.random.default_rng(2), 512, 32)
    multi = FM.fused_merge(tab, torch.from_numpy(raw), torch.from_numpy(lens))
    single = FM.fused_merge_plain(
        dataclasses.replace(tab, minsuper=None), torch.from_numpy(raw), torch.from_numpy(lens)
    )
    assert all(torch.equal(x, y) for x, y in zip(multi, single))
    assert (multi[0] >= HIGH).any()
    for i in range(64):
        n = int(multi[1][i])
        assert multi[0][i, :n].tolist() == oracle.encode_word(ctx, bytes(raw[i, : lens[i]]), None)


def _shifted_byte_vocab():
    """The big-merges fixture with every id from 256 on moved up by
    0x10000: ids pass 16 bits, the 3,274 merges.txt ranks do not."""
    base, _enc = tp.load("big-merges")

    def shift(i):
        return i if i < 256 else i + HIGH

    str2id = {t: shift(i) for t, i in base.vocab.str2id.items()}
    vocab = Vocab(str2id=str2id, id2str={i: t for t, i in str2id.items()}, size=max(str2id.values()) + 1)
    rules = {(shift(a), shift(b)): (r, shift(m)) for (a, b), (r, m) in base.merges.rules.items()}
    ctx = TokenizerContext(
        vocab=vocab, special_chars=base.special_chars, is_byte_encoder=True,
        merges=MergeRules(rules=rules, num_rules=base.merges.num_rules),
    )
    return build_encoder_tables(ctx), ctx


# ---------------------------------------------------------- the engine


@pytest.mark.parametrize("name", CONFIGS)
def test_engine_matches_jax_engine_and_oracle(name, wide, monkeypatch):
    """``encode_batch`` and ``encode_batch_arrays`` against the JAX engine
    (R-matrix path) and the oracle; the device path ran, ids past 16 bits
    came out, and ``HUTOKEN_TPU_RAW=1`` still takes the word pipeline."""
    ctx, _enc, jax_engine, port = wide(name)
    docs = _docs(1)
    port.reset_cache()
    words0 = port.stat_device_words
    got = port.encode_batch(docs)
    assert got == jax_engine.encode_batch(docs)
    assert got == [oracle.encode(ctx, d) for d in docs]
    assert port.stat_device_words > words0 and port.stat_flagged_words == 0
    assert _max_id(got) >= HIGH
    flat, offs = port.encode_batch_arrays(docs[::-1])
    want_flat, want_offs = jax_engine.encode_batch_arrays(docs[::-1])
    assert np.array_equal(flat, want_flat) and np.array_equal(offs, want_offs)
    monkeypatch.setenv("HUTOKEN_TPU_RAW", "1")
    port.reset_cache()
    assert port.encode_batch(docs) == got
    assert port._raw_enc is None


def test_charmode_vocab_above_16_bits(monkeypatch):
    """A char-mode vocabulary of <0xNN> literals and composites whose ids
    start above 0xFFFF (after tests/test_adversarial_vocabs.py::
    test_hex_literal_dense_vocab): its id blocks take the eager wide
    fixed point and equal the JAX engine and the oracle."""
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 4)
    toks: dict[bytes, int] = {b"": 0}
    nid = 0x10005
    for b in range(0x00, 0x20):
        toks[f"<0x{b:02X}>".encode()] = nid
        nid += 1
    for ch in "abcdefgh ":
        toks[ch.encode()] = nid
        nid += 1
    for s in (b"ab", b"abc", b"<0x0A>a", b"a<0x0A>", b"<0x0A><0x0D>", b"cd", b"cde", b"hg", b"fgh"):
        toks[s] = nid
        nid += 1
    vocab = Vocab(str2id=dict(toks), id2str={v: k for k, v in toks.items()}, size=nid)
    ctx = TokenizerContext(
        vocab=vocab, special_chars={0x0A: b"<0x0A>", 0x0D: b"<0x0D>"}, is_byte_encoder=False
    )
    rng = random.Random(5)
    texts = ["ab\ncd", "a\n", "\na", "\n\r", "abc abc", "h\rg"] + [
        "".join(rng.choice("abcdefgh \n\r") for _ in range(rng.randint(1, 40))) for _ in range(60)
    ]
    want = [oracle.encode(ctx, t) for t in texts]
    port = E.TorchTokenizer(ctx, device="cpu")
    assert port.dev_tables.wide and port.dev_tables.byte_seed is None
    assert port.encode_batch(texts) == want
    assert JE.TpuTokenizer(ctx).encode_batch(texts) == want
    assert port.stat_device_words > 0
    assert min(t for ids in want for t in ids) > 0xFFFF


# ------------------------------------------------------------- decode


@pytest.mark.parametrize("name", CONFIGS)
def test_device_decode_matches_native(name, wide):
    """Device decode of an int32 stream of a 100,256-id vocabulary:
    ``decode_batch_device`` equals the native decode and the text, and
    ``decode_arrays_device`` equals ``decode_arrays`` on random ids from
    the whole range."""
    ctx, _enc, _jax_engine, port = wide(name)
    native = NativeEngine(ctx)
    docs = _docs(3, 150)  # past the 16 KB that the host fills itself
    token_lists = native.encode_batch(docs, 1)
    assert _max_id(token_lists) >= HIGH
    calls = D.decode_tokens_blob.calls
    assert port.decode_batch_device(token_lists) == docs == native.decode_batch(token_lists, 1)
    assert D.decode_tokens_blob.calls == calls + 1
    assert port._dec_tok_dtype == np.int32
    rng = np.random.default_rng(9)
    flat = rng.integers(0, ctx.vocab.size, 20000).astype(np.int64)
    offs = np.concatenate(([0, 0], np.sort(rng.integers(0, 20000, 30)), [20000]))
    blob, boffs = port.decode_arrays_device(flat, offs)
    want_blob, want_offs = native.decode_arrays(flat, offs)
    assert np.array_equal(boffs, want_offs)
    assert blob.numpy()[: boffs[-1]].tobytes() == want_blob


def test_decode_table_past_int32_offsets_is_refused(monkeypatch):
    """``ops/decode.py`` computes ``id * ld`` in int32: a decoded-bytes
    table of 2^31 entries or more is refused with the reason."""
    v, s = ft.write_byte_level_fixture()
    port = E.TorchTokenizer(TokenizerContext.load(v, s, is_byte_encoder=True), device="cpu")
    huge = np.lib.stride_tricks.as_strided(np.zeros(1, np.uint8), (1 << 26, 32), (0, 0))
    monkeypatch.setattr(port, "_decode_fast", False)
    monkeypatch.setattr(port, "_build_decode_general", lambda: (huge, True))
    with pytest.raises(ValueError, match="int32 offsets"):
        port._ensure_decode_device()


# ------------------------------------------------------------- facade


@pytest.fixture()
def facades():
    hutoken._reset()
    yield
    hutoken._reset()
    jax_facade._reset()


def test_facade_matches_jax_facade(wide_files, facades):
    """The port's facade (``backend="device"`` on the CPU) against the JAX
    facade on ``batch_encode`` over the merges configuration, and its
    device decode back to the text."""
    vocab, special, merges = wide_files
    docs = _docs(4, 150)
    jax_facade.initialize(vocab, special, is_byte_encoder=True, merges_file_path=merges, backend="host")
    want = jax_facade.batch_encode(docs)
    hutoken.initialize(
        vocab, special, is_byte_encoder=True, merges_file_path=merges, backend="device", device="cpu"
    )
    got = hutoken.batch_encode(docs)
    assert got == want and _max_id(got) >= HIGH
    assert hutoken._engine.dev_tables.wide
    calls = D.decode_tokens_blob.calls
    assert hutoken.batch_decode(got) == docs
    assert D.decode_tokens_blob.calls == calls + 1


# --------------------------------------------------------------- card


@pytest.mark.cuda
@pytest.mark.parametrize("name", CONFIGS)
def test_wide_kernel_matches_twin_on_cuda(name, wide_files):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    vocab, special, merges = wide_files
    ctx = TokenizerContext.load(
        vocab, special, is_byte_encoder=True, merges_file_path=merges if name == "merges" else None
    )
    tab = device_tables(build_encoder_tables(ctx), ctx, "cuda")
    assert tab.wide
    from hutoken_tpu_torch.ops.merge import compact_output

    for width in (8, 16, 32):
        raw, lens = _word_block(30 + width, 12345, width)
        lens[::5] = 0
        lens[1::5] = np.minimum(lens[1::5], 1)
        r, n = torch.from_numpy(raw).cuda(), torch.from_numpy(lens).cuda()
        launches = FM.merge_words_from_bytes_fused.wide_launches
        got = FM.merge_words_from_bytes_fused(tab, r, n, False)
        want = compact_output(FM.fused_merge_plain(tab, r, n)[0], False)
        torch.cuda.synchronize()
        assert FM.merge_words_from_bytes_fused.wide_launches == launches + 1
        read = 12345 + int(want[:12345].sum())
        assert torch.equal(got[:read], want[:read])
