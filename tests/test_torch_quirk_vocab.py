"""Vocabularies with published-vocab quirks in the PyTorch port
(``TorchTokenizer`` on CPU tensors), held to the port's scalar oracle and
its native host engine; token ids are integers, so every comparison is
exact (tolerance 0).

* The quirk vocabulary of ``tests/test_gpt2_shape_conformance.py``: id
  holes, a 128-byte token chain, specials read as text.
* The witness of the 16-bit repair: ids of 0x10000 or more on a
  vocabulary of fewer than 0xFFFF lines.  16-bit output must be gated on
  the largest id, not on the line count; the JAX engine gates on the
  line count (``hutoken_tpu/engine.py:262``) and cuts 70,001 to 4,465,
  so these tests compare with the oracle and the native engine, not
  with it.  The byte seeds sit at 0-255 with "he" = 70,000 and "hel" =
  70,001 (the wide pair table: the pipeline and the eager path), or
  with byte "z" moved to 70,002, "he" = 4,466 and "hec" = 257: every
  pair fits 16 bits, but the narrow table's 16-bit key would read the
  seed pair (70,002, "c") as the rule ("he", "c"), so the table must be
  the wide one.

The engine's blocks are cut to 64 / 16 rows, as in
``tests/test_torch_engine.py``, so that the small batches reach the
device path (the fused twin for words of up to 32 bytes, the eager
fixed point for 33-128)."""

import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import oracle  # noqa: E402
from hutoken_tpu_torch.bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table  # noqa: E402
from hutoken_tpu_torch.context import TokenizerContext  # noqa: E402
from hutoken_tpu_torch.formats import write_special_chars_file, write_vocab_file  # noqa: E402
from hutoken_tpu_torch.native import NativeEngine  # noqa: E402
from hutoken_tpu_torch.parallel import data_mesh  # noqa: E402

torch.set_num_threads(1)

B2U = gpt2_bytes_to_unicode()


def _spell(s: bytes) -> bytes:
    return "".join(B2U[x] for x in s).encode("utf-8")


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _load(tmp_path, id2str: dict, name: str) -> TokenizerContext:
    vpath = os.path.join(tmp_path, f"{name}-vocab.txt")
    spath = os.path.join(tmp_path, f"{name}-special.txt")
    write_vocab_file(vpath, id2str)
    write_special_chars_file(spath, gpt2_special_chars_table())
    return TokenizerContext.load(vpath, spath, is_byte_encoder=True)


def _quirk_ctx(tmp_path) -> TokenizerContext:
    """``tests/test_gpt2_shape_conformance.py::_write_quirk_vocab``: a
    128-byte token, an ``<|endoftext|>`` token and id-space holes."""
    id2str = {b: B2U[b].encode("utf-8") for b in range(256)}
    id2str[256] = _spell(b"he")
    id2str[257] = _spell(b"hel")
    id2str[258] = _spell(b"hell")
    id2str[259] = _spell(b"hello")
    # id hole: 260..299 unused
    id2str[300] = _spell(b"<|")
    id2str[301] = _spell(b"|>")
    word = b"endoftext"
    for i in range(2, len(word) + 1):
        id2str[308 + i] = _spell(word[:i])  # ids 310..317
    id2str[303] = _spell(b"<|endoftext|>")  # present but parser-split
    for i, ln in enumerate((2, 4, 8, 16, 32, 64, 128)):
        id2str[320 + i] = _spell(b"a" * ln)
    return _load(tmp_path, id2str, "quirk")


def _hole_ctx(tmp_path, narrow: bool) -> TokenizerContext:
    """The 70,000 / 70,001 vocabulary, or (``narrow``) byte "z" at
    70,002 with "he" = 4,466 (70,002 & 0xFFFF) and "hec" = 257."""
    id2str = {b: B2U[b].encode("utf-8") for b in range(256)}
    if narrow:
        id2str[70002] = id2str.pop(ord("z"))
        id2str[4466], id2str[257] = _spell(b"he"), _spell(b"hec")
    else:
        id2str[70000], id2str[70001] = _spell(b"he"), _spell(b"hel")
    return _load(tmp_path, id2str, "narrow" if narrow else "holes")


def _hole_docs() -> list[str]:
    """2,000 words "hel" + 1-8 letters of "abcdefgxyz" in 40 documents."""
    rng = random.Random(0)
    words = ["hel" + "".join(rng.choice("abcdefgxyz") for _ in range(rng.randint(1, 8)))
             for _ in range(2000)]
    return [" ".join(words[i : i + 50]) for i in range(0, 2000, 50)]


def _long_docs() -> list[str]:
    """Documents of words of 33-100 bytes: the eager bucket."""
    rng = random.Random(1)
    words = ["hel" + "".join(rng.choice("abcdefgxyz") for _ in range(rng.randint(30, 97)))
             for _ in range(400)]
    return [" ".join(words[i : i + 20]) for i in range(0, 400, 20)]


def _want(ctx, docs):
    want = [oracle.encode(ctx, d) for d in docs]
    assert NativeEngine(ctx).encode_batch(docs, 2) == want
    return want


# ------------------------------------------------------ quirk vocabulary


def test_quirk_vocab_exact(tmp_path):
    """Long tokens, specials as text and id holes resolve exactly; decode
    of an id at or past the line count raises (reference parity: decode
    bounds use the number of vocab lines)."""
    ctx = _quirk_ctx(tmp_path)
    assert oracle.encode_word(ctx, b"hello", None) == [259]
    assert oracle.encode_word(ctx, b"a" * 128, None) == [326]
    assert oracle.encode_word(ctx, b"a" * 129, None) == [326, 97]
    assert oracle.encode_word(ctx, b"a" * 192, None) == [326, 325]
    assert oracle.encode(ctx, "<|endoftext|>") == [300, 317, 301]
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert tok.encode_batch(["hello"]) == [[259]]
    assert tok.decode_batch([[259]]) == ["hello"]
    with pytest.raises((ValueError, RuntimeError)):
        tok.decode_batch([[326]])


@pytest.mark.parametrize("raw", ["0", "1"])
def test_quirk_vocab_engine_matches_oracle_and_native(tmp_path, monkeypatch, raw):
    monkeypatch.setenv("HUTOKEN_TPU_RAW", raw)
    ctx = _quirk_ctx(tmp_path)
    rng = random.Random(5)
    docs = [
        "hello hello aaaa",
        "<|endoftext|> hello",
        "a" * 200,
        "hell " + "a" * 128,
    ] + [" ".join(rng.choice(["hello", "hell", "he", "a" * rng.randint(1, 130), "<|", "|>", "endoftext"])
                  for _ in range(40)) for _ in range(30)]
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert tok.encode_batch(docs) == _want(ctx, docs)
    assert tok.stat_device_words > 0


# ----------------------------------------------- 16-bit repair witness


@pytest.mark.parametrize("raw", ["0", "1"])
def test_witness_ids_past_16_bits_on_few_lines(tmp_path, monkeypatch, raw):
    """The repair's witness: with 258 lines and ids 70,000 / 70,001 every
    document equals the oracle (before the repair the device path gave
    4,465 for 70,001 and no document was equal)."""
    monkeypatch.setenv("HUTOKEN_TPU_RAW", raw)
    ctx = _hole_ctx(tmp_path, narrow=False)
    docs = _hole_docs()
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert ctx.vocab.size == 258 and tok.dev_tables.wide and not tok._u16_out
    got = tok.encode_batch(docs)
    assert got == _want(ctx, docs)
    assert got[0][0] == 70001
    assert tok.stat_device_words > 0


def test_witness_eager_path(tmp_path):
    """Words of 33-100 bytes take the eager fixed point."""
    ctx = _hole_ctx(tmp_path, narrow=False)
    docs = _long_docs()
    tok = E.TorchTokenizer(ctx, device="cpu")
    got = tok.encode_batch(docs)
    assert got == _want(ctx, docs)
    assert tok.stat_device_words > 0 and any(70001 in g for g in got)


def test_witness_encode_batch_arrays(tmp_path):
    ctx = _hole_ctx(tmp_path, narrow=False)
    docs = _hole_docs() + _long_docs()
    flat, offs = E.TorchTokenizer(ctx, device="cpu").encode_batch_arrays(docs)
    want = _want(ctx, docs)
    assert flat.dtype == np.int32 and offs.shape == (len(docs) + 1,)
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(docs))] == want


def test_witness_mesh(tmp_path):
    ctx = _hole_ctx(tmp_path, narrow=False)
    docs = _hole_docs() + _long_docs()
    tok = E.TorchTokenizer(ctx, mesh=data_mesh(2, "cpu"))
    assert tok.encode_batch(docs) == _want(ctx, docs)
    assert min(tok.stat_shard_fused) > 0


def _narrow_layout(enc):
    """The narrow packed table of ``enc``'s pairs, built by hand: the
    layout ``device_tables`` took before the emitted ids counted."""
    from hutoken_tpu_torch.tables import DeviceTables, build_pair_table

    pt = build_pair_table(enc.pairs)
    assert pt.packed_ok  # every pair fits 16 bits
    pkey, pval = pt.packed_arrays()
    packed = np.stack([pkey, pval, np.zeros_like(pkey), np.zeros_like(pkey)], axis=1)
    return DeviceTables(pslots=torch.from_numpy(np.ascontiguousarray(packed)), slots=None,
                        probe_len=pt.probe_len, cap_mask=pt.capacity - 1, byte_seed=None, minsuper=None)


@pytest.mark.parametrize("raw", ["0", "1"])
def test_witness_narrow_table_past_16_bits(tmp_path, monkeypatch, raw):
    """A byte seed at 70,002 with every pair in 16 bits.  On the narrow
    table its key is that of the rule ("he" = 4,466, "c") and lies in
    that probe chain, so "zc" would encode as "hec"; the seed's id takes
    the wide table (and so never the raw path), and every document,
    with "zc" in many, equals the oracle."""
    from hutoken_tpu_torch.ops.merge import probe_pairs_packed

    monkeypatch.setenv("HUTOKEN_TPU_RAW", raw)
    ctx = _hole_ctx(tmp_path, narrow=True)
    docs = _hole_docs() + ["zc hezc zchec " * 40]
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert tok.tables.pair_table is None  # the wide layout builds no probe-4 table
    a, c = torch.tensor([70002]), torch.tensor([ord("c")])
    assert probe_pairs_packed(_narrow_layout(tok.tables), a, c)[1].tolist() == [257]
    assert tok.dev_tables.wide and not tok._u16_out
    got = tok.encode_batch(docs)
    assert got == _want(ctx, docs) and tok._raw_enc is None
    assert oracle.encode(ctx, "zc") == [70002, ord("c")]
    assert sum(g.count(70002) for g in got) > 100 and tok.stat_device_words > 0


@pytest.mark.parametrize("name", ["small", "big-vocab", "big-merges"])
def test_fixtures_keep_16_bit_output(name):
    """Every other vocabulary keeps its output: the committed fixtures'
    largest ids fit 16 bits."""
    from hutoken_tpu_torch.scripts.common import load_ctx

    assert E.TorchTokenizer(load_ctx(name), device="cpu")._u16_out
