"""Device decode in the PyTorch port, on the CPU: ``ops/decode.py``
against the JAX package's ``hutoken_tpu/ops/decode.py`` on seeded inputs;
``TorchTokenizer``'s decode against the oracle, mirroring
tests/test_decode_device.py; the facade's decode routing; and a device
decode that leaves ``jax`` unloaded.  Decoded bytes are compared
exactly."""

import os
import random
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
import torch_parity as tp  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.context import TokenizerContext  # noqa: E402
from hutoken_tpu.ops import decode as JD  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.ops import decode as D  # noqa: E402

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TEXTS = [
    "A gyors barna róka átugrik a lusta kutya fölött.",
    " The quick brown fox jumps over the lazy dog.",
    "Öt szűk ütközőpont: 0xFF, 3.14159.",
    "   multiple   spaces\tand\nnewlines\r\nare whitespace too.",
    "emoji 🙂 and 中文 chars",
    "x",
    "",
]


# ---------------------------------------------------------------- ops


def _table(rng, V: int, ld: int):
    """A decoded-bytes table [V, ld] with per-id counts in 0..ld (about
    a tenth zero-length)."""
    counts = rng.integers(0, ld + 1, V).astype(np.int32)
    counts[rng.random(V) < 0.1] = 0
    dec = rng.integers(1, 256, (V, ld)).astype(np.uint8)
    dec[np.arange(ld)[None, :] >= counts[:, None]] = 0
    return dec, counts


def _stream(rng, V: int, n: int, dtype):
    """n token ids drawn from the whole id range (so a u16 stream holds
    ids >= 0x8000), zero-length spellings included."""
    return rng.integers(0, V, n).astype(dtype)


@pytest.mark.parametrize("V,dtype", [(300, np.int32), (40000, np.uint16), (70000, np.int32)])
@pytest.mark.parametrize("n_valid", [0, 1, 700, 1024])
def test_decode_tokens_blob_matches_jax(V, dtype, n_valid):
    rng = np.random.default_rng(V + n_valid)
    ld = 5
    dec, counts = _table(rng, V, ld)
    N = 1024
    toks = np.zeros(N, dtype)
    toks[:n_valid] = _stream(rng, V, n_valid, dtype)
    if dtype == np.uint16:
        assert n_valid < 700 or (toks >= 0x8000).any()
        port_toks = torch.from_numpy(toks.view(np.int16))
    else:
        port_toks = torch.from_numpy(toks)
    total = int(counts[toks[:n_valid].astype(np.int64)].sum())
    out_size = 1 << max(total, 1).bit_length()
    want = np.asarray(JD.decode_tokens_blob(dec.reshape(-1), counts, toks, n_valid, out_size, ld))
    got = D.decode_tokens_blob(torch.from_numpy(dec.reshape(-1)), torch.from_numpy(counts),
                               port_toks, n_valid, out_size, ld)
    assert got.dtype == torch.uint8 and got.shape == (out_size,)
    # bytes past the total are padding in both; the real ones must agree
    assert np.array_equal(got.numpy()[:total], want[:total])
    ids = toks[:n_valid].astype(np.int64)
    oracle_bytes = b"".join(dec[i, : counts[i]].tobytes() for i in ids)
    assert got.numpy()[:total].tobytes() == oracle_bytes
    assert np.array_equal(got.numpy(), want)  # padding too: same clip rule


@pytest.mark.parametrize("dtype", [np.int32, np.uint16])
def test_decode_tokens_blob_tot_matches_jax(dtype):
    rng = np.random.default_rng(11)
    V, ld, N, n_valid = 40000, 4, 2048, 1500
    dec, counts = _table(rng, V, ld)
    toks = np.zeros(N, dtype)
    toks[:n_valid] = _stream(rng, V, n_valid, dtype)
    # boundaries at 0 (an empty first document), inside, at n_valid; padded
    bounds = np.array([0, 0, 1, 17, 900, 900, n_valid], dtype=np.int32)
    dl = np.zeros(64, np.int32)
    dl[: bounds.shape[0]] = bounds
    out_size = 1 << 13
    want_blob, want_aux = JD.decode_tokens_blob_tot(
        dec.reshape(-1), counts, toks, n_valid, dl, out_size, ld
    )
    port_toks = torch.from_numpy(toks.view(np.int16) if dtype == np.uint16 else toks)
    before = D.decode_tokens_blob_tot.calls
    blob, aux = D.decode_tokens_blob_tot(
        torch.from_numpy(dec.reshape(-1)), torch.from_numpy(counts), port_toks, n_valid,
        torch.from_numpy(dl), out_size, ld,
    )
    assert D.decode_tokens_blob_tot.calls == before + 1
    assert aux.dtype == torch.int32 and np.array_equal(aux.numpy(), np.asarray(want_aux))
    assert np.array_equal(blob.numpy(), np.asarray(want_blob))
    total = int(aux[0])
    assert total == int(counts[toks[:n_valid].astype(np.int64)].sum()) <= out_size
    cum = np.concatenate(([0], np.cumsum(counts[toks[:n_valid].astype(np.int64)])))
    assert np.array_equal(aux.numpy()[1 : 1 + len(bounds)], cum[bounds])


@pytest.mark.parametrize("offset", [0, 100, 250, 1000, -5])
def test_write_chunk_matches_jax_and_clamps(offset):
    rng = np.random.default_rng(offset + 10)
    out = rng.integers(0, 256, 300).astype(np.uint8)
    chunk = rng.integers(0, 256, 64).astype(np.uint8)
    want = np.asarray(JD.write_chunk(out.copy(), chunk, np.int32(offset)))
    port_out = torch.from_numpy(out.copy())
    got = D.write_chunk(port_out, torch.from_numpy(chunk), offset)
    assert got is port_out  # in place, as the reference donates out
    assert np.array_equal(got.numpy(), want)
    if offset > 300 - 64:  # clamped so that the chunk fits
        assert np.array_equal(got.numpy()[-64:], chunk)
    with pytest.raises(ValueError, match="exceeds"):
        D.write_chunk(torch.zeros(10, dtype=torch.uint8), torch.zeros(11, dtype=torch.uint8), 0)


# ------------------------------------------------------------- engine
# tests/test_decode_device.py, test for test, against TorchTokenizer


@pytest.fixture(scope="module")
def engine_ctx():
    v, s = ft.write_byte_level_fixture()
    ctx = TokenizerContext.load(v, s, is_byte_encoder=True)
    return E.TorchTokenizer(ctx, device="cpu"), ctx


def _charmode_ctx(prefix="▁"):
    v, s = ft.write_char_mode_fixture()
    return TokenizerContext.load(v, s, prefix=prefix, is_byte_encoder=False)


def test_device_decode_matches_oracle(engine_ctx):
    engine, ctx = engine_ctx
    token_lists = [oracle.encode(ctx, t) for t in TEXTS]
    assert engine.decode_batch_device(token_lists) == TEXTS


def test_device_decode_roundtrip_fuzz(engine_ctx):
    engine, ctx = engine_ctx
    rng = random.Random(3)
    words = ft.CORPUS.split()
    docs = [
        " ".join(rng.choice(words) for _ in range(rng.randrange(0, 30)))
        for _ in range(100)
    ]
    token_lists = [oracle.encode(ctx, d) for d in docs]
    assert engine.decode_batch_device(token_lists) == docs
    big = [t for tl in token_lists for t in tl] * 40
    assert len(big) > (1 << 16)
    calls = D.decode_tokens_blob.calls
    assert engine.decode_batch_device([big]) == engine.decode_batch([big])
    assert D.decode_tokens_blob.calls > calls  # the stream took the device path


def test_device_decode_bounds(engine_ctx):
    engine, _ctx = engine_ctx
    with pytest.raises(ValueError, match="non-negative"):
        engine.decode_batch_device([[10], [99999999]])


def test_decode_env_switch(engine_ctx, monkeypatch):
    engine, ctx = engine_ctx
    token_lists = [oracle.encode(ctx, t) for t in TEXTS] * 100  # > 16 KB: launches
    monkeypatch.setenv("HUTOKEN_TPU_DECODE", "device")
    calls = D.decode_tokens_blob.calls
    assert engine.decode_batch(token_lists) == TEXTS * 100
    assert D.decode_tokens_blob.calls == calls + 1


def test_decode_arrays_device_resident(engine_ctx):
    """Run for real (the JAX suite skips it on the CPU): the blob is a
    tensor on the engine's device, downloaded once to check it."""
    engine, _ctx = engine_ctx
    docs = TEXTS[:4] + TEXTS[5:]  # byte mode turns the emoji into '?'
    flat, offs = engine.encode_batch_arrays(docs)
    calls = D.decode_tokens_blob_tot.calls
    blob_dev, boffs = engine.decode_arrays_device(flat, offs)
    assert D.decode_tokens_blob_tot.calls == calls + 1
    assert isinstance(blob_dev, torch.Tensor) and blob_dev.dtype == torch.uint8
    assert blob_dev.device == engine.device
    blob = blob_dev.numpy().tobytes()
    for i, d in enumerate(docs):
        assert blob[boffs[i] : boffs[i + 1]].decode("utf-8") == d


def test_device_decode_charmode_prefix_matches_oracle():
    engine = E.TorchTokenizer(_charmode_ctx(), device="cpu")
    ctx = engine.ctx
    texts = [
        "A gyors barna róka átugrik a lusta kutya fölött.",
        " leading space engages the prefix-token run",
        "Öt szűk ütközőpont",
        "multi  spaces",
        "x",
        "",
    ]
    token_lists = [oracle.encode(ctx, t) for t in texts]
    want = [oracle.decode(ctx, ids) for ids in token_lists]
    assert engine.decode_batch_device(token_lists) == want


def test_device_decode_charmode_large_stream():
    engine = E.TorchTokenizer(_charmode_ctx(), device="cpu")
    ctx = engine.ctx
    rng = np.random.default_rng(7)
    base = "a gyors barna róka átugrik a lusta kutya fölött és szalad "
    docs = ["".join(rng.permutation(list(base * 8)).tolist()) for _ in range(40)]
    token_lists = [oracle.encode(ctx, t) for t in docs]
    want = [oracle.decode(ctx, ids) for ids in token_lists]
    assert sum(len(w.encode()) for w in want) > (1 << 14)  # really launches
    calls = D.decode_tokens_blob.calls
    assert engine.decode_batch_device(token_lists) == want
    assert D.decode_tokens_blob.calls == calls + 1


def test_device_decode_fused_matches_bucketed_corpus(engine_ctx):
    engine, ctx = engine_ctx
    token_lists = [oracle.encode(ctx, d) for d in TEXTS if d] * 60
    want = [oracle.decode(ctx, ids) for ids in token_lists]
    assert engine.decode_batch_device(token_lists) == want


def test_straddle_detector_scan_phase():
    """A replacement value that is not char-aligned shifts the reverse
    scan's phase; the shared detector flags the id and the stream takes
    the exact host path."""
    from hutoken_tpu.formats import Vocab

    str2id = {bytes([i]): i for i in range(256)}
    str2id[b"b\xc3\xc3"] = 256
    str2id[b"\xa9x"] = 257
    id2str = {v: k for k, v in str2id.items()}
    vocab = Vocab(str2id=str2id, id2str=id2str, size=len(str2id))
    ctx = TokenizerContext(
        vocab=vocab, special_chars={7: b"b\xc3"}, is_byte_encoder=False,
        max_special_char_len=2,
    )
    engine = E.TorchTokenizer(ctx, device="cpu")
    assert engine._ensure_decode_device()
    assert engine._dec_host_only[256], "phase-shifted straddle not flagged"
    want = oracle.reverse_remap_nostrip(ctx, id2str[256] + id2str[257])
    got = engine.decode_batch_device([[256, 257]])
    assert got[0].encode("utf-8", "surrogateescape") == want or (
        got[0] == want.decode("utf-8", "replace")
    )


def test_decode_arrays_device_charmode_fallback_exact():
    """A flagged stream takes the exact host fallback even without the
    native library (the numpy decode_arrays is byte-encoder-only), and
    the result is still a blob on the device."""
    engine = E.TorchTokenizer(_charmode_ctx(prefix=None), device="cpu")
    ctx = engine.ctx
    engine._native_split_ok = False
    engine._ensure_decode_device()
    ids = oracle.encode(ctx, "gyors barna")
    engine._dec_host_only[ids[0]] = True
    calls = D.decode_tokens_blob_tot.calls
    blob, boffs = engine.decode_arrays_device(
        np.asarray(ids, dtype=np.int64), np.array([0, len(ids)], dtype=np.int64)
    )
    assert D.decode_tokens_blob_tot.calls == calls
    assert isinstance(blob, torch.Tensor)
    want = oracle.reverse_remap_nostrip(ctx, b"".join(ctx.vocab.id2str[i] for i in ids))
    assert bytes(blob.numpy()[: boffs[-1]]) == want


def test_decode_multi_chunk_stitching(engine_ctx, monkeypatch):
    """Tiny quanta: the stream spans dozens of chunks, covering the chunk
    cuts, per-chunk v rebasing and write_chunk stitching."""
    engine, ctx = engine_ctx
    monkeypatch.setattr(type(engine), "DEC_N_QUANTA", (1 << 6, 1 << 8))
    monkeypatch.setattr(type(engine), "DEC_T_QUANTA", (1 << 8, 1 << 10))
    token_lists = [oracle.encode(ctx, t) for t in TEXTS if t] * 120
    want = [oracle.decode(ctx, ids) for ids in token_lists]
    calls = D.decode_tokens_blob.calls
    assert engine.decode_batch_device(token_lists) == want
    assert D.decode_tokens_blob.calls - calls > 20

    flat = np.concatenate([np.asarray(t, np.int64) for t in token_lists])
    offs = np.concatenate(([0], np.cumsum([len(t) for t in token_lists]))).astype(np.int64)
    blob_dev, boffs = engine.decode_arrays_device(flat, offs)
    blob = blob_dev.numpy().tobytes()
    for i, w in enumerate(want):
        assert blob[boffs[i] : boffs[i + 1]].decode("utf-8") == w


def test_decode_multi_chunk_blob_sizing(engine_ctx, monkeypatch):
    """The stitched blob fits every chunk's full padded write, even when
    an early chunk's padded size exceeds all the real bytes after it."""
    engine, ctx = engine_ctx
    monkeypatch.setattr(type(engine), "DEC_N_QUANTA", (64, 256))
    monkeypatch.setattr(type(engine), "DEC_T_QUANTA", (256, 4096))
    engine._ensure_decode_device()
    tid = next(int(i) for i in range(256, ctx.vocab.size) if engine._dec_counts[i] >= 3)
    ids = [tid] * 300
    want = engine._decode_batch_host([ids])[0]
    blob_dev, boffs = engine.decode_arrays_device(
        np.asarray(ids, dtype=np.int64), np.array([0, len(ids)], dtype=np.int64)
    )
    assert blob_dev.numpy()[: boffs[-1]].tobytes().decode("utf-8") == want


# --------------------------------------------------- beyond the mirror


@pytest.mark.parametrize("name", ["big-vocab", "big-merges"])
def test_device_decode_matches_native_on_the_big_fixture(name):
    """The 23,096-id fixture (a uint16 stream): device decode equals the
    native decode (which the JAX engine's host decode runs) on corpus
    documents, and on random ids from the whole id range as bytes."""
    from hutoken_tpu.native import NativeEngine

    ctx, _enc = tp.load(name)
    engine = E.TorchTokenizer(ctx, device="cpu")
    native = NativeEngine(ctx)
    docs = [ft.CORPUS[i : i + 400] for i in range(0, 8000, 400)] * 3 + ["", "x"]
    token_lists = native.encode_batch(docs, 1)
    calls = D.decode_tokens_blob.calls
    assert engine.decode_batch_device(token_lists) == docs == native.decode_batch(token_lists, 1)
    assert D.decode_tokens_blob.calls == calls + 1
    rng = np.random.default_rng(9)
    flat = rng.integers(0, ctx.vocab.size, 20000).astype(np.int64)
    assert (flat >= 0x4000).any()
    offs = np.concatenate(([0, 0], np.sort(rng.integers(0, 20000, 30)), [20000]))
    blob, boffs = engine.decode_arrays_device(flat, offs)
    want_blob, want_offs = native.decode_arrays(flat, offs)
    assert np.array_equal(boffs, want_offs)
    assert blob.numpy()[: boffs[-1]].tobytes() == want_blob


def test_decode_arrays_device_prediction_overflow_falls_back_exact(engine_ctx, monkeypatch):
    """A bytes-per-token prediction that undershoots (a chunk's real total
    above its output quantum) redoes the call exactly on the host and
    raises the estimate."""
    engine, ctx = engine_ctx
    engine._ensure_decode_device()
    monkeypatch.setattr(type(engine), "DEC_T_QUANTA", (1 << 12, 1 << 13))
    monkeypatch.setattr(engine, "_dec_bpt", 0.001)
    tid = int(np.argmax(engine._dec_counts))
    ids = np.full(4000, tid, dtype=np.int64)
    offs = np.array([0, 4000], dtype=np.int64)
    blob, boffs = engine.decode_arrays_device(ids, offs)
    want, want_offs = engine.decode_arrays(ids, offs)
    assert boffs[-1] > (1 << 13) and np.array_equal(boffs, want_offs)
    assert blob.numpy().tobytes() == want
    assert engine._dec_bpt > 1.0


def test_decode_arrays_device_rejects_prefix_configs():
    engine = E.TorchTokenizer(_charmode_ctx(), device="cpu")
    with pytest.raises(ValueError, match="no-prefix"):
        engine.decode_arrays_device(np.zeros(1, np.int64), np.array([0, 1]))


# ------------------------------------------------------------- facade


@pytest.fixture()
def facade(monkeypatch):
    monkeypatch.delenv("HUTOKEN_TPU_DECODE", raising=False)
    hutoken._reset()
    yield monkeypatch
    hutoken._reset()


def _init(**kw):
    v, s = ft.write_byte_level_fixture()
    hutoken.initialize(v, s, is_byte_encoder=True, **kw)


def test_facade_device_backend_decodes_on_the_device(facade):
    """The repaired divergence: under backend="device" decode goes to the
    engine's device path, as the JAX facade's does."""
    _init(backend="device", device="cpu")
    ctx = hutoken._ctx
    token_lists = [oracle.encode(ctx, t) for t in TEXTS] * 100
    calls = D.decode_tokens_blob.calls
    assert hutoken.batch_decode(token_lists) == TEXTS * 100
    assert D.decode_tokens_blob.calls == calls + 1
    assert hutoken._engine is not None and hutoken._engine._prefer_device_decode
    big = sum(token_lists, [])
    assert hutoken.decode(big) == "".join(TEXTS * 100)
    assert D.decode_tokens_blob.calls == calls + 2
    with pytest.raises(ValueError, match="non-negative"):
        hutoken.decode([10, 99999999])


def test_facade_auto_backend_decodes_on_the_host(facade):
    _init(backend="auto", device="cpu")
    token_lists = [oracle.encode(hutoken._ctx, t) for t in TEXTS] * 100
    calls = D.decode_tokens_blob.calls
    assert hutoken.batch_decode(token_lists) == TEXTS * 100
    assert hutoken._engine is None and D.decode_tokens_blob.calls == calls
    facade.setenv("HUTOKEN_TPU_DECODE", "device")
    assert hutoken.decode(sum(token_lists[:7], [])) == "".join(TEXTS)
    assert hutoken._engine is None  # single decode under auto: the host
    assert hutoken.batch_decode(token_lists) == TEXTS * 100
    assert hutoken._engine is not None and D.decode_tokens_blob.calls == calls + 1


def test_facade_without_cuda_decodes_on_the_host(facade):
    """device="cuda" (the default) without a CUDA device: default-backend
    decode still runs on the host and raises nothing; backend="device"
    raises, since its engine needs the device."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _init()
    token_lists = [oracle.encode(hutoken._ctx, t) for t in TEXTS]
    assert hutoken.batch_decode(token_lists) == TEXTS
    assert hutoken.decode(token_lists[0]) == TEXTS[0]
    _init(backend="device")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        hutoken.batch_decode(token_lists)


def test_device_decode_leaves_jax_unloaded():
    """tests/conftest.py imports jax into this process, so the check runs
    in a fresh interpreter."""
    v, s = ft.write_byte_level_fixture()
    code = (
        "import sys, torch; torch.set_num_threads(1)\n"
        "import hutoken_tpu_torch as ht\n"
        "from hutoken_tpu_torch.ops import decode as D\n"
        f"ht.initialize({v!r}, {s!r}, is_byte_encoder=True, backend='device', device='cpu')\n"
        "docs = ['a gyors barna róka ' * 40, ' The quick brown fox ' * 40] * 20\n"
        "ids = ht.batch_encode(docs)\n"
        "assert ht.batch_decode(ids) == docs and D.decode_tokens_blob.calls == 1\n"
        "import numpy as np\n"
        "flat, offs = ht._engine.encode_batch_arrays(docs)\n"
        "blob, boffs = ht._engine.decode_arrays_device(flat, offs)\n"
        "assert blob.numpy()[: boffs[-1]].tobytes() == ''.join(docs).encode()\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'hutoken_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr
