"""The port's device string trainer, whole, against the JAX package's
``distributed_bpe_train`` and the host ``bpe_train_core(strict=False)``
on the CPU, tolerance 0: the corpora of tests/test_parallel.py
(:121-155, 286-305, 328-343) through the speculative scan driver
(``HUTOKEN_TPU_STRING_SCAN=16``, the default) on 1 and 8 shards, with
the vocab, the ``.merges`` log and ``STRING_SCAN_STATS`` equal to JAX's.
The per-merge loop, checkpoint/resume and the runs at a forced small
candidate depth are in tests/test_torch_train_string_loop.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import hutoken_tpu.parallel.train as JT  # noqa: E402
import hutoken_tpu_torch.parallel.train as PT  # noqa: E402
from hutoken_tpu.parallel.mesh import data_mesh as jax_mesh  # noqa: E402
from hutoken_tpu_torch.parallel import data_mesh  # noqa: E402
from hutoken_tpu_torch.train.bpe import bpe_train_core  # noqa: E402
from test_torch_train import meshes  # noqa: E402,F401
from test_torch_train_string import ABAB, shallow  # noqa: E402

torch.set_num_threads(1)


def _words():
    rng = np.random.default_rng(3)
    words = ["the", "cat", "sat", "on", "mat", "dog", "szó", "árvíz"]
    return (" ".join(rng.choice(words, 400).tolist())).encode()


def _random():
    rng = np.random.default_rng(3)
    rng.choice(8, 400)  # the draw of _words, which the corpus follows
    return bytes(rng.integers(97, 103, 4000).astype(np.uint8))


def _fuzz(trial):
    rng = np.random.default_rng(321)
    for _ in range(trial + 1):
        alpha = int(rng.integers(2, 6))
        n = int(rng.integers(60, 900))
        corpus = bytes((97 + rng.integers(0, alpha, n)).astype(np.uint8))
        vs = 256 + int(rng.integers(4, 50))
    return corpus, vs


# name -> () -> (corpus, vocab size): tests/test_parallel.py's corpora,
# the id quirk's and the three fuzz draws
CASES = {
    "words": lambda: (_words(), 300),
    "szavak": lambda: (b"szia vilag szep szavak szava szsz " * 24, 300),
    "abab": lambda: (ABAB, 300),
    "random": lambda: (_random(), 300),
    "id-quirk": lambda: (b"abababab " * 20, 260),
    **{f"fuzz-{t}": (lambda t=t: _fuzz(t)) for t in range(3)},
}


def _train(module, corpus, vs, mesh, ckpt, **kw):
    """(vocab, checkpoint file, .merges log, STRING_SCAN_STATS of the run)."""
    for k in module.STRING_SCAN_STATS:
        module.STRING_SCAN_STATS[k] = 0
    vocab = module.distributed_bpe_train(corpus, vs, mesh=mesh, verbose=False, checkpoint_path=ckpt, **kw)
    files = [open(ckpt + suffix, "rb").read() for suffix in ("", ".merges")]
    return vocab, *files, dict(module.STRING_SCAN_STATS)


def check_against_jax_and_host(meshes, name, scan, tmp_path, monkeypatch):
    """The run of CASES[name] under ``HUTOKEN_TPU_STRING_SCAN=scan``
    equals the host core's vocab and JAX's vocab, files and stats."""
    jm, pm = meshes
    monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
    corpus, vs = CASES[name]()
    got = _train(PT, corpus, vs, pm, str(tmp_path / "p.txt"))
    want = _train(JT, corpus, vs, jm, str(tmp_path / "j.txt"))
    assert got[0] == bpe_train_core(corpus, vs, strict=False, verbose=False)
    assert got == want
    if name == "id-quirk":
        assert 256 not in got[0].values() and b"ab" in got[0]  # count+1 (src/bpe.c:171)


@pytest.mark.parametrize("name", list(CASES))
def test_scan_driver_equals_jax_and_host(meshes, name, tmp_path, monkeypatch):
    check_against_jax_and_host(meshes, name, "16", tmp_path, monkeypatch)
