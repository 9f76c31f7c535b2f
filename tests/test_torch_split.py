"""The raw cache-cold path of the PyTorch port (hutoken_tpu_torch/ops/
split.py and TorchTokenizer._encode_core_raw) on the CPU, against the
JAX package's ops/split.py and raw engine path (Pallas in interpret
mode) and the scalar oracle.  Token ids are integers: every comparison
is exact."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench  # noqa: E402
import fixture_tools as ft  # noqa: E402
import torch_parity as tp  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.engine import RAW_MIN_BYTES  # noqa: E402
from hutoken_tpu.ops import split as JS  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.ops import seg_merge as SM  # noqa: E402
from hutoken_tpu_torch.ops import split as S  # noqa: E402
from test_split_device import ALPHABETS, ALPHABETS_SUPPORTED  # noqa: E402

torch.set_num_threads(1)
SMALL = dict(C=8192, Tcap=8192, Fcap=128, Dcap=64)
# the port's stream has a slot per byte, so it has no token capacity
PORT_SMALL = dict(C=8192, Fcap=128, Dcap=64)
EDGE_CASES = [
    "", " ", "  ", "a", " a", "  a", "   a", "a b", "a  b",
    "\t", "\t\t", " \t ", "a\tb", "\na", "a\n b", "ab12cd",
    "!?!", " !?", "a!b", "1a2b", "őű ő ű", " ő", "  ő", "a ő",
    "aő1ő", "ő!ű", " \nx", "x \ny",
]
RESET_DOCS = ["abc", " x", "  y", "1", "!", "", "q1", " ", "  "]


def _bytes(s: str) -> np.ndarray:
    return np.frombuffer(s.encode("utf-8"), dtype=np.uint8)


def _torch_mask(chunk: np.ndarray, lens: list[int]) -> np.ndarray:
    """The torch start mask over documents of byte lengths ``lens``
    (empty documents take no segment, as in the engine)."""
    ends = np.cumsum([n for n in lens if n]).astype(np.int32)
    if not chunk.shape[0]:
        return np.zeros(0, dtype=bool)
    return S.start_mask(torch.from_numpy(chunk.copy()), torch.from_numpy(ends)).numpy()


# ------------------------------------------------------------ helpers


def test_constants_and_luts_equal_reference():
    assert (S._ACC_C3, S._ACC_C5) == (JS._ACC_C3, JS._ACC_C5)
    assert (S._ACC3_LO, S._ACC3_HI, S._ACC5_LO, S._ACC5_HI) == (
        JS._ACC3_LO, JS._ACC3_HI, JS._ACC5_LO, JS._ACC5_HI
    )
    assert np.array_equal(S._cut_lut(), JS._cut_lut())
    assert S.MAX_WORD == JS.MAX_WORD


def test_acc_member_torch_equals_numpy():
    low6 = np.arange(64, dtype=np.int32)
    for lo, hi in ((S._ACC3_LO, S._ACC3_HI), (S._ACC5_LO, S._ACC5_HI)):
        want = JS._acc_member(low6, lo, hi)
        assert np.array_equal(S._acc_member(torch.from_numpy(low6), lo, hi).numpy(), want)


@pytest.mark.parametrize("alphabet", sorted(ALPHABETS_SUPPORTED))
def test_start_masks_equal_reference(alphabet):
    rng = random.Random(hash(alphabet) & 0xFFFF)
    chars = ALPHABETS_SUPPORTED[alphabet]
    for _ in range(200):
        s = "".join(rng.choice(chars) for _ in range(rng.randrange(0, 60)))
        raw = _bytes(s)
        assert S.supported_alphabet(raw) == JS.supported_alphabet(raw)
        want = JS.np_start_mask(raw, np.zeros(1, dtype=np.int64))
        assert np.array_equal(_torch_mask(raw, [raw.shape[0]]), want), repr(s)


def test_start_masks_edge_cases():
    for s in EDGE_CASES:
        raw = _bytes(s)
        want = JS.np_start_mask(raw, np.zeros(1, dtype=np.int64))
        assert np.array_equal(_torch_mask(raw, [raw.shape[0]]), want), repr(s)


def test_start_masks_document_reset():
    rng = random.Random(7)
    for _ in range(200):
        chosen = [rng.choice(RESET_DOCS) for _ in range(rng.randrange(1, 5))]
        blobs = [d.encode("utf-8") for d in chosen]
        chunk = np.frombuffer(b"".join(blobs), dtype=np.uint8)
        lens = [len(b) for b in blobs]
        doc_starts = np.cumsum([0] + lens[:-1]).astype(np.int64)
        want = JS.np_start_mask(chunk, doc_starts)
        assert np.array_equal(_torch_mask(chunk, lens), want), chosen


def test_supported_alphabet_and_find_cut_equal_reference():
    for s in ["abc", "őű", "áé!? 12", "", "£", "…", "😀", "naïve£"]:
        assert S.supported_alphabet(_bytes(s)) == JS.supported_alphabet(_bytes(s))
    for raw in ([0x80], [0xC3], [0x41, 0xC5]):
        arr = np.array(raw, dtype=np.uint8)
        assert S.supported_alphabet(arr) is JS.supported_alphabet(arr) is False
    rng = random.Random(99)
    for _ in range(300):
        s = "".join(rng.choice(ALPHABETS["mixed"]) for _ in range(rng.randrange(0, 120)))
        raw = _bytes(s)
        lo = rng.randrange(0, max(raw.shape[0], 1))
        hi = rng.randrange(lo, raw.shape[0] + 1)
        assert S.find_cut(raw, lo, hi) == JS.find_cut(raw, lo, hi)


def test_chunk_words():
    raw = _bytes("ab  cd\tx" + "y" * 40 + "  1")
    starts, lens = S.chunk_words(
        torch.from_numpy(raw.copy()), torch.tensor([7, raw.shape[0]], dtype=torch.int32)
    )
    want = np.flatnonzero(JS.np_start_mask(raw, np.array([0, 7], dtype=np.int64)))
    assert starts.tolist() == want.tolist()
    assert lens.tolist() == np.diff(want, append=raw.shape[0]).tolist()
    assert lens.max() == 41  # "xyyy..." from the reset at byte 7


# ------------------------------------------------------- chunk level


@pytest.fixture(scope="module")
def toks():
    """(JAX TpuTokenizer in interpret mode, port TorchTokenizer) on the
    small fixture."""
    mp = pytest.MonkeyPatch()
    mp.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    from hutoken_tpu.engine import TpuTokenizer

    ctx, _enc = tp.load("small")
    jtok = TpuTokenizer(ctx)
    assert jtok._pallas_tab is not None and not jtok._pallas_tab.partial
    yield jtok, E.TorchTokenizer(ctx, device="cpu")
    mp.undo()


def _chunk(docs):
    blobs = [d.encode("utf-8") for d in docs]
    chunk = np.frombuffer(b"".join(blobs), dtype=np.uint8)
    return chunk, np.cumsum([len(b) for b in blobs]).astype(np.int32)


def _both(toks, docs, **caps):
    jtok, ptok = toks
    chunk, seg_ends = _chunk(docs)
    jenc = JS.RawChunkEncoder(jtok, **{**SMALL, **caps})
    penc = S.RawChunkEncoder(ptok, **{**PORT_SMALL, **caps})
    return (
        jenc.finish(jenc.launch(chunk, seg_ends), chunk),
        penc.finish(penc.launch(chunk, seg_ends), chunk),
    )


def _check_chunk(toks, docs):
    (jt, jseg, jst), (pt, pseg, pst) = _both(toks, docs)
    assert pt.tolist() == jt.tolist(), docs
    assert pseg.tolist() == jseg.tolist(), docs
    for key in ("words", "flagged_words", "device_bytes", "over_bucket", "partial_flag"):
        assert pst[key] == jst[key], key
    want = [oracle.encode(toks[1].ctx, d) for d in docs]
    assert pt.tolist() == [t for w in want for t in w]
    assert pseg.tolist() == [len(w) for w in want]
    return pst


def test_raw_chunk_basic(toks):
    _check_chunk(toks, ["hello world", " leading space", "multi  space", "x"])


def test_raw_chunk_fuzz(toks):
    rng = random.Random(31)
    chars = "abcdefghij XY12!?\t\nőű.,"
    for _ in range(30):
        docs = [
            "".join(rng.choice(chars) for _ in range(rng.randrange(1, 200)))
            for _ in range(rng.randrange(1, 8))
        ]
        _check_chunk(toks, docs)


def test_raw_chunk_long_words_flagged(toks):
    stats = _check_chunk(toks, ["short " + "q" * 60 + " tail", "w" * 33, "a" * 100 + " b"])
    # the space before the q run belongs to its word
    assert stats["flagged_words"] == 3 and stats["over_bucket"] == 61 + 33 + 100


def test_raw_chunk_single_bytes_and_empty(toks):
    # the engine never puts an empty document in a chunk
    _check_chunk(toks, ["\t", "\t\t\t", " ", "a", "\n\n"])


def test_raw_chunk_capacity_overflow_returns_none(toks):
    _jtok, ptok = toks
    chunk, seg_ends = _chunk([" ".join(["z" * 40] * 5)])  # 5 long words
    enc = S.RawChunkEncoder(ptok, C=8192, Fcap=4, Dcap=64)
    assert enc.finish(enc.launch(chunk, seg_ends), chunk) is None
    enc = S.RawChunkEncoder(ptok, C=8192, Fcap=5, Dcap=64)
    assert enc.finish(enc.launch(chunk, seg_ends), chunk) is not None
    # a stream slot per byte: 4000 unmergeable 1-byte words fit
    chunk, seg_ends = _chunk(["a1" * 2000])
    enc = S.RawChunkEncoder(ptok, C=8192, Fcap=128, Dcap=64)
    got, _seg, _stats = enc.finish(enc.launch(chunk, seg_ends), chunk)
    assert got.tolist() == oracle.encode(ptok.ctx, "a1" * 2000)


def test_encode_chunk_u16_stream():
    """u16 vocabularies come back as int16 bit patterns."""
    ctx, _enc = tp.load("big-merges")
    ptok = E.TorchTokenizer(ctx, device="cpu")
    assert ptok._u16_out
    docs = [ft.CORPUS[:1500], " Árvíztűrő tükörfúrógép"]
    chunk, seg_ends = _chunk(docs)
    meta, stream = S.encode_chunk(
        ptok.dev_tables, torch.from_numpy(chunk.copy()), torch.from_numpy(seg_ends),
        Fcap=16, u16_out=True,
    )
    assert stream.dtype == torch.int16 and stream.shape == (chunk.shape[0],)
    enc = S.RawChunkEncoder(ptok, C=8192)
    got, seg, _stats = enc.finish(enc.launch(chunk, seg_ends), chunk)
    want = [oracle.encode(ctx, d) for d in docs]
    assert got.tolist() == [t for w in want for t in w]
    assert seg.tolist() == [len(w) for w in want]
    assert int(meta[1]) == got.shape[0]


# ------------------------------------------------------------ engine


def _engines(monkeypatch, raw: str, name: str = "small"):
    monkeypatch.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    monkeypatch.setenv("HUTOKEN_TPU_RAW", raw)
    monkeypatch.setenv("HUTOKEN_TPU_RAW_C", "8192")
    from hutoken_tpu.engine import TpuTokenizer

    ctx, _enc = tp.load(name)
    return TpuTokenizer(ctx), E.TorchTokenizer(ctx, device="cpu")


def test_engine_raw_path_multichunk(monkeypatch):
    """The corpus of test_engine_raw_path_multichunk: several chunks,
    documents cut across chunks, an empty one and a long word."""
    jtok, ptok = _engines(monkeypatch, "1")
    rng = random.Random(77)
    chars = "abcdefghij XY12!?\nőű.,"
    docs = ["".join(rng.choice(chars) for _ in range(rng.randrange(0, 1500))) for _ in range(40)]
    docs += ["big " * 4000, "", "x" * 40]
    got = ptok.encode_batch(docs)
    assert ptok._raw_enc is not None and ptok.stat_device_bytes > 0
    assert got == jtok.encode_batch(docs)
    assert got == [oracle.encode(ptok.ctx, d) for d in docs]
    assert ptok.stat_device_bytes == jtok.stat_device_bytes
    assert ptok.stat_device_words == jtok.stat_device_words
    assert ptok.stat_host_cause == jtok.stat_host_cause
    assert set(ptok.stat_host_cause) == {"raw_host_chunk", "over_bucket"}


def test_engine_raw_chunks_hold_at_most_dcap_documents(monkeypatch):
    _jtok, ptok = _engines(monkeypatch, "1")
    ptok._raw_enc = enc = S.RawChunkEncoder(ptok, C=8192, Dcap=3)
    n_segs = []
    real = enc.launch
    monkeypatch.setattr(enc, "launch", lambda c, e: n_segs.append(e.shape[0]) or real(c, e))
    docs = [f"doc {i} words" for i in range(10)] + ["", "x" * 40]
    assert ptok.encode_batch(docs) == [oracle.encode(ptok.ctx, d) for d in docs]
    assert n_segs == [3, 3, 3, 2]


def test_engine_raw_path_unsupported_alphabet(monkeypatch):
    jtok, ptok = _engines(monkeypatch, "1")
    docs = ["hello £ world…", "naïve 😀 text", "plain ascii"]
    got = ptok.encode_batch(docs)
    assert got == [oracle.encode(ptok.ctx, d) for d in docs]
    assert got == jtok.encode_batch(docs)
    assert ptok.stat_host_cause["raw_host_chunk"] > 0


def test_engine_raw_arrays_api(monkeypatch):
    jtok, ptok = _engines(monkeypatch, "1")
    docs = ["alpha beta", "gamma  delta", ""]
    flat, offs = ptok.encode_batch_arrays(docs)
    want_flat, want_offs = jtok.encode_batch_arrays(docs)
    assert np.array_equal(flat, want_flat) and np.array_equal(offs, want_offs)
    for i, d in enumerate(docs):
        assert flat[offs[i] : offs[i + 1]].tolist() == oracle.encode(ptok.ctx, d)


def test_engine_raw_document_without_cut_after_a_cut(monkeypatch):
    """A document cut once whose remainder has no safe cut within a full
    chunk: the remainder alone goes to the host (the JAX engine sends
    the whole document there again and repeats its first part)."""
    _jtok, ptok = _engines(monkeypatch, "1")
    docs = ["lead", "a1" + "a" * 20000 + " end", "tail x"]
    assert ptok.encode_batch(docs) == [oracle.encode(ptok.ctx, d) for d in docs]
    assert ptok.stat_host_cause["raw_host_chunk"] == 20004


@pytest.mark.parametrize("name", ["big-merges", "big-vocab"])
def test_engine_raw_path_big_fixtures(monkeypatch, name):
    """The 23,096-id tables through the raw path (the JAX engine's
    big-vocab Pallas table is partial, so the oracle is the reference)."""
    _jtok, ptok = _engines(monkeypatch, "1", name)
    docs = bench.build_unique_corpus(0.012)
    docs += [ft.CORPUS[:3000], "x" * 50 + " y"]
    assert ptok.encode_batch(docs) == [oracle.encode(ptok.ctx, d) for d in docs]
    assert ptok.stat_device_bytes > 0.5 * sum(len(d.encode()) for d in docs)


def test_auto_routes_like_reference(monkeypatch):
    """Under auto, >= RAW_MIN_BYTES of unique text takes the raw path
    (the plain twin of seg_merge runs); repetitive text does not."""
    monkeypatch.setenv("HUTOKEN_TPU_RAW", "auto")
    ctx, _enc = tp.load("small")
    calls = []
    real = SM.seg_merge_plain
    monkeypatch.setattr(SM, "seg_merge_plain", lambda *a: calls.append(1) or real(*a))
    unique = bench.build_unique_corpus(RAW_MIN_BYTES / 1e6 * 1.02)
    assert sum(len(t) for t in unique) >= RAW_MIN_BYTES
    tok = E.TorchTokenizer(ctx, device="cpu")
    got = tok.encode_batch(unique)
    assert calls and tok._raw_enc is not None
    assert tok.stat_device_bytes >= 0.99 * sum(len(t.encode()) for t in unique)
    assert tok.stat_host_cause.get("raw_host_chunk", 0) == 0
    sample = range(0, len(unique), 97)
    assert [got[i] for i in sample] == [oracle.encode(ctx, unique[i]) for i in sample]

    calls.clear()
    rep = ["the cat sat on the mat " * 200] * 200
    assert sum(len(t) for t in rep) >= RAW_MIN_BYTES
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert tok.encode_batch(rep[:3]) == [oracle.encode(ctx, rep[0])] * 3
    tok.encode_batch(rep)
    assert not calls and tok._raw_enc is None


def test_raw_probe_is_the_reference(monkeypatch):
    jtok, ptok = _engines(monkeypatch, "0")
    rng = random.Random(5)
    uniq = [
        " ".join("".join(rng.choice("abcdefghijklmnop") for _ in range(8)) for _ in range(200))
        for _ in range(8)
    ]
    rep = [("the cat sat on the mat " * 200) for _ in range(8)]
    for corpus in (uniq, rep):
        assert ptok._raw_probe(corpus) == jtok._raw_probe(corpus)
    assert ptok._raw_probe(uniq) > 0.6 and ptok._raw_probe(rep) < 0.2
    ptok._native_split_ok = False  # the python split gives the same ratio
    assert ptok._raw_probe(uniq) == pytest.approx(jtok._raw_probe(uniq), abs=0.05)
