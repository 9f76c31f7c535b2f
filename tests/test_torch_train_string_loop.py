"""The port's device string trainer, whole, on the CPU, tolerance 0:
the corpora of tests/test_parallel.py through the per-merge loop
(``HUTOKEN_TPU_STRING_SCAN=0``) on 1 and 8 shards, equal to the host
``bpe_train_core(strict=False)`` and to JAX's vocab, ``.merges`` log and
``STRING_SCAN_STATS``; checkpoint/resume; and runs with the candidate
tables cut to a few rows, which drive the deep, probe and exact host
picks, on 1, 4 and 8 shards under both drivers."""

import pytest

torch = pytest.importorskip("torch")

import hutoken_tpu.parallel.train as JT  # noqa: E402
import hutoken_tpu_torch.parallel.train as PT  # noqa: E402
from hutoken_tpu.parallel.mesh import data_mesh as jax_mesh  # noqa: E402
from hutoken_tpu_torch.parallel import data_mesh  # noqa: E402
from hutoken_tpu_torch.train.bpe import bpe_train_core  # noqa: E402
from test_torch_train import meshes  # noqa: E402,F401
from test_torch_train_string import shallow  # noqa: E402
from test_torch_train_string_runs import CASES, _train, check_against_jax_and_host  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("name", list(CASES))
def test_per_merge_loop_equals_jax_and_host(meshes, name, tmp_path, monkeypatch):
    check_against_jax_and_host(meshes, name, "0", tmp_path, monkeypatch)


def test_checkpoint_and_resume_match_straight_run(meshes, tmp_path):
    """As tests/test_parallel.py:328-343: train a prefix checkpointing
    every merge (the checkpoint files equal JAX's), resume to the end."""
    jm, pm = meshes
    corpus = b"szo beszed szobeszed szosz " * 30
    straight = PT.distributed_bpe_train(corpus, 280, mesh=pm, verbose=False)
    ck = str(tmp_path / "ck.txt")
    prefix = _train(PT, corpus, 265, pm, ck, checkpoint_every=1)
    assert prefix[1:3] == _train(JT, corpus, 265, jm, str(tmp_path / "j.txt"), checkpoint_every=1)[1:3]
    resumed = PT.distributed_bpe_train(corpus, 280, mesh=pm, verbose=False, checkpoint_path=ck,
                                       resume=True)
    assert resumed == straight == bpe_train_core(corpus, 280, strict=False, verbose=False)


@pytest.mark.parametrize("shards", [1, 4, 8])
@pytest.mark.parametrize("name", ["words", "abab", "random"])
def test_forced_depth_equals_host(shards, name, tmp_path, monkeypatch):
    """Candidate tables cut to 2 rows a shard (the deep table keeps
    ``DEEP_K``): the bound fails nearly every step, so the deep pick,
    the probes and the exact host pick decide.  Under both drivers the
    port equals the host core; where JAX does too (one shard: no
    duplicate rows), its vocab, log and stats equal JAX's."""
    corpus, vs = CASES[name]()
    host = bpe_train_core(corpus, vs, strict=False, verbose=False)
    shallow(monkeypatch, PT, 2)
    shallow(monkeypatch, JT, 2)
    picks = 0
    for scan in ("16", "0"):
        monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
        got = _train(PT, corpus, vs, data_mesh(shards, device="cpu"), str(tmp_path / "p.txt"))
        assert got[0] == host, scan
        picks += got[3]["deep_picks"] + got[3]["exact_picks"]
        if shards == 1:
            assert got == _train(JT, corpus, vs, jax_mesh(1), str(tmp_path / "j.txt"))
    assert picks > 0
