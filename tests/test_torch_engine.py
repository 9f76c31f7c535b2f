"""TorchTokenizer (hutoken_tpu_torch/engine.py) on the CPU against the
JAX engine (Pallas in interpret mode) and the scalar oracle, on the
committed fixtures.  Token ids are integers: every comparison is exact.

Blocks are cut to a few dozen rows so that small batches fill whole
blocks and reach the device path (the fused twin for words of up to 32
bytes, the eager fixed point for 33-128) instead of the host tail."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
import fixture_tools as ft  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402

torch.set_num_threads(1)
CONFIGS = ["small", "big-vocab", "big-merges", "charmode"]


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _docs(seed: int, n: int = 120) -> list[str]:
    rng = np.random.default_rng(seed)
    letters = list("abcdefghijklmnopqrstuvwxyzáéőű0123456789")
    words = [w.decode() for w in tp.corpus_words()]
    docs = []
    for _ in range(n):
        parts = []
        for _ in range(rng.integers(1, 30)):
            kind = rng.random()
            if kind < 0.5:
                parts.append(words[rng.integers(0, len(words))].strip())
            else:
                ln = int(rng.integers(1, 12) if kind < 0.9 else rng.integers(20, 150))
                parts.append("".join(rng.choice(letters, ln)))
        docs.append(" ".join(parts) + str(rng.choice(["", ".", "!\n", "  \t"])))
    return docs + [ft.CORPUS[:2000], "", " ", "x", " leading space"]


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_batch_matches_jax_engine_and_oracle(name, monkeypatch):
    monkeypatch.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    from hutoken_tpu.engine import TpuTokenizer

    ctx, _enc = tp.load(name)
    docs = _docs(1)
    tok = E.TorchTokenizer(ctx, device="cpu")
    got = tok.encode_batch(docs)
    assert got == TpuTokenizer(ctx).encode_batch(docs)
    assert got == [oracle.encode(ctx, d) for d in docs]
    assert tok.stat_device_words > 0 and tok.stat_flagged_words == 0


@pytest.mark.parametrize("name", CONFIGS)
def test_encode_batch_arrays_matches_jax_engine(name, monkeypatch):
    monkeypatch.setenv("HUTOKEN_TPU_PALLAS", "interpret")
    from hutoken_tpu.engine import TpuTokenizer

    ctx, _enc = tp.load(name)
    docs = _docs(2)
    flat, offs = E.TorchTokenizer(ctx, device="cpu").encode_batch_arrays(docs)
    want_flat, want_offs = TpuTokenizer(ctx).encode_batch_arrays(docs)
    assert np.array_equal(flat, want_flat) and np.array_equal(offs, want_offs)


@pytest.mark.parametrize("name", ["small", "big-merges"])
def test_python_core_matches_pipelined(name):
    """Without the native splitter the engine takes _encode_core_py; the
    ids must not change, with a cold or a warm word cache."""
    ctx, _enc = tp.load(name)
    docs = _docs(3)
    piped = E.TorchTokenizer(ctx, device="cpu")
    want = piped.encode_batch(docs)
    assert piped._native_split_ok
    tok = E.TorchTokenizer(ctx, device="cpu")
    tok._native_split_ok = False
    assert tok.encode_batch(docs) == want
    assert tok.encode_batch(docs) == want  # warm cache
    tok.reset_cache()
    assert tok.encode_batch(docs[::-1]) == want[::-1]


def test_device_counters_track_launches():
    ctx, _enc = tp.load("small")
    tok = E.TorchTokenizer(ctx, device="cpu")
    docs = _docs(4)
    tok.encode_batch(docs)
    first = tok.stat_device_bytes
    assert first > 0
    tok.encode_batch(docs)  # every word is cached now
    assert tok.stat_device_bytes == first
    tok.reset_cache()
    tok.encode_batch(docs)
    assert tok.stat_device_bytes == 2 * first


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    ctx, _enc = tp.load("small")
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        E.TorchTokenizer(ctx, device="cuda")


def test_embedded_null_raises():
    ctx, _enc = tp.load("small")
    with pytest.raises(ValueError, match="embedded null character"):
        E.TorchTokenizer(ctx, device="cpu").encode_batch(["ok", "a\x00b"])
