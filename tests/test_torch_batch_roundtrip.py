"""Large-batch round trip through the PyTorch port's facade (the
counterpart of ``tests/test_batch_roundtrip.py``): ``batch_encode`` then
``batch_decode`` gives the documents back, on the host engine and on the
device engine's CPU twins (``device="cpu"``), whose blocks are cut to
64 / 16 rows so that the batch reaches the device path."""

import random

import pytest

pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import oracle  # noqa: E402


@pytest.fixture(autouse=True)
def _fresh_facade(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    hutoken._reset()
    yield
    hutoken._reset()


def _docs(n: int) -> list[str]:
    rng = random.Random(4242)
    words = ft.CORPUS.split()
    docs = []
    for _ in range(n):
        k = rng.randrange(1, 40)
        t = " ".join(rng.choice(words) for _ in range(k))
        if rng.random() < 0.2:
            t = " " + t
        if rng.random() < 0.2:
            t = t + "\n"
        docs.append(t)
    return docs


def test_batch_roundtrip_2k_host():
    v, s = ft.write_byte_level_fixture()
    hutoken.initialize(v, s, is_byte_encoder=True, backend="host")
    docs = _docs(2000)
    toks = hutoken.batch_encode(docs, num_threads=8)
    assert hutoken.batch_decode(toks, num_threads=8) == docs


def test_batch_roundtrip_500_device():
    v, s = ft.write_byte_level_fixture()
    hutoken.initialize(v, s, is_byte_encoder=True, backend="device", device="cpu")
    docs = _docs(500)
    toks = hutoken.batch_encode(docs)
    assert toks == [oracle.encode(hutoken._ctx, d) for d in docs]
    assert hutoken.batch_decode(toks) == docs
    assert hutoken._get_engine().stat_device_words > 0
