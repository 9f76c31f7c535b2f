"""Latency of the PyTorch port's device engine on the card (the
counterpart of ``tests/test_latency.py:41-91``), with the JAX tests'
bounds: a warm single short document under 5 ms, a never-seen single
word under 0.25 s.

Marked ``cuda``: they need the card and skip here.  Wall-clock bounds
also flake when the suite runs on several workers at once (the JAX
version does under six), so they run on the card alone:
``python -m pytest tests/test_torch_latency.py -m cuda``."""

import random
import time
import timeit

import pytest

torch = pytest.importorskip("torch")

from hutoken_tpu_torch.engine import TorchTokenizer  # noqa: E402
from hutoken_tpu_torch.scripts.common import load_ctx  # noqa: E402

SENTENCE = "How can the net amount of entropy of the universe be massively decreased?"


def _engine():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: a latency bound on the CPU twins measures nothing")
    engine = TorchTokenizer(load_ctx("small"), device="cuda")
    engine.warmup()
    return engine


@pytest.mark.cuda
def test_device_engine_encode_latency():
    """A warm single short document: every word is cached, so nothing
    reaches the card and the bound holds the host layer."""
    engine = _engine()
    engine.encode_batch([SENTENCE])
    number = 500
    mean = timeit.timeit(lambda: engine.encode_batch([SENTENCE]), number=number) / number
    print(f"mean device-engine warm encode latency: {mean * 1e3:.3f} ms")
    assert mean < 5e-3, f"warm device-path encode too slow: {mean}"


@pytest.mark.cuda
def test_device_engine_cold_word_latency():
    """A single never-seen word at a time."""
    engine = _engine()
    engine.encode_batch(["warmup words fill shapes"])
    rng = random.Random(123)
    words = ["".join(rng.choice("abcdefghijklmnop") for _ in range(9)) for _ in range(200)]
    t0 = time.perf_counter()
    for w in words:
        engine.encode_batch([w])
    torch.cuda.synchronize()
    mean = (time.perf_counter() - t0) / len(words)
    print(f"mean device-engine cold-word encode latency: {mean * 1e3:.3f} ms")
    assert mean < 0.25, f"cold-word device-path encode too slow: {mean}"
