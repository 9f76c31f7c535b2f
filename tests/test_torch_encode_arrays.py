"""``encode_batch_arrays`` in the PyTorch port (the counterpart of
``tests/test_encode_arrays.py``): the plain path and the insertion of the
standalone prefix run (``np.insert`` for documents that start with a
space, reference semantics src/core.c:421-446), against
``encode_batch``, the port's oracle and its native host engine, on CPU
tensors.  Ids are integers: every comparison is exact.

Blocks are cut to 64 / 16 rows so that the small batches reach the
device path."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import oracle  # noqa: E402
from hutoken_tpu_torch.context import TokenizerContext  # noqa: E402
from hutoken_tpu_torch.native import NativeEngine  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _check_arrays_match_lists(engine, ctx, docs):
    flat, offs = engine.encode_batch_arrays(docs)
    lists = engine.encode_batch(docs)
    want = [oracle.encode(ctx, d) for d in docs]
    assert lists == want
    assert NativeEngine(ctx).encode_batch(docs, 2) == want
    assert offs.shape == (len(docs) + 1,)
    assert int(offs[-1]) == len(flat)
    for i, d in enumerate(docs):
        assert flat[offs[i] : offs[i + 1]].tolist() == want[i], f"doc {i}: {d[:30]!r}"
    return flat, offs


def test_encode_batch_arrays_byte_level():
    v, s = ft.write_byte_level_fixture()
    ctx = TokenizerContext.load(v, s, is_byte_encoder=True)
    engine = E.TorchTokenizer(ctx, device="cpu")
    rng = random.Random(21)
    words = ft.CORPUS.split()
    docs = [
        " ".join(rng.choice(words) for _ in range(rng.randrange(0, 25)))
        for _ in range(50)
    ] + ["", " ", "x", "  double  spaced  "]
    _check_arrays_match_lists(engine, ctx, docs)
    assert engine.stat_device_words > 0


def test_encode_batch_arrays_prefix_run_insert():
    """Char mode with a prefix: space-initial documents get the standalone
    prefix run inserted at their start (the ``np.insert`` branch)."""
    v, s = ft.write_char_mode_fixture()
    ctx = TokenizerContext.load(v, s, prefix="▁")
    engine = E.TorchTokenizer(ctx, device="cpu")
    rng = random.Random(22)
    words = [w for w in ft.CORPUS.split() if w.isascii()]
    docs = []
    for i in range(30):
        body = " ".join(rng.choice(words) for _ in range(rng.randrange(1, 12)))
        docs.append((" " if i % 2 else "") + body)
    docs += [" leading space", "no leading space", "  two spaces"]
    flat, offs = _check_arrays_match_lists(engine, ctx, docs)
    run = engine._prefix_token_run()
    assert run
    for i, d in enumerate(docs):
        toks = flat[offs[i] : offs[i + 1]].tolist()
        if d.startswith(" ") and toks:
            assert toks[: len(run)] == run


def test_encode_batch_arrays_empty_batch():
    v, s = ft.write_byte_level_fixture()
    ctx = TokenizerContext.load(v, s, is_byte_encoder=True)
    flat, offs = E.TorchTokenizer(ctx, device="cpu").encode_batch_arrays([])
    assert len(flat) == 0
    assert np.array_equal(offs, np.zeros(1, dtype=offs.dtype))
