"""The port's device byte-level BPE trainer (hutoken_tpu_torch/parallel)
against the JAX package's, on the CPU, tolerance 0 (integers).

Each shard op runs on the same seeded shards through the port and
through the JAX op under ``shard_map`` on the 8-device CPU mesh that
tests/conftest.py sets up (or a 1-device one); then the whole trainer,
on 1 and 8 CPU shards, against JAX's ``distributed_bbpe_train`` and the
host ``bbpe_train_core`` (vocab and merge log) on the corpora of
tests/test_parallel.py, checkpoint/resume, the facade, and the mesh.
Tests marked ``cuda`` run the trainer on the card and skip here."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import shard_map  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import fixture_tools as ft  # noqa: E402
import hutoken_tpu as J  # noqa: E402
import hutoken_tpu.parallel.train as JT  # noqa: E402
import hutoken_tpu_torch as PF  # noqa: E402
import hutoken_tpu_torch.parallel.train as PT  # noqa: E402
from hutoken_tpu.parallel.mesh import data_mesh as jax_mesh  # noqa: E402
from hutoken_tpu_torch.parallel import collectives as C  # noqa: E402
from hutoken_tpu_torch.parallel import DataMesh, data_mesh, shard_batch  # noqa: E402
from hutoken_tpu_torch.train.bbpe import bbpe_train_core  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module", params=[1, 8], ids=["1-shard", "8-shard"])
def meshes(request):
    """(the JAX mesh, the port's CPU mesh) of the same shard count."""
    if len(jax.devices()) < request.param:
        pytest.skip("needs 8 JAX devices")
    return jax_mesh(request.param), data_mesh(request.param, device="cpu")


def _shard_rows(rng, n_dev, n, alpha, empty=(), live=None):
    """``n_dev`` shards of ``n`` ids below ``alpha``, each a live prefix
    and -1 pads (the compaction invariant); ``empty`` shards hold none."""
    rows = []
    for s in range(n_dev):
        k = 0 if s in empty else (live[s] if live else int(rng.integers(1, n + 1)))
        row = np.full(n, -1, np.int32)
        row[:k] = rng.integers(0, alpha, k)
        rows.append(row)
    return np.concatenate(rows)


def _port_shards(flat, n_dev):
    return [torch.from_numpy(r.copy()) for r in np.split(flat, n_dev)]


def _jax(fn, mesh, in_specs, out_specs, *args):
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs))(*args)


def _eq(got, want):
    """Port tensors (or lists of shards) equal JAX arrays exactly."""
    if isinstance(got, list):
        got = torch.cat(got)
    got, want = np.asarray(got.numpy()), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype, (got.dtype, want.dtype)
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------ shard ops


@pytest.mark.parametrize("n", [1, 2, 7, 64, 1000])
def test_merge_mask_and_compact_equal_jax(n):
    rng = np.random.default_rng(n)
    for density in (0.2, 0.5, 0.9):
        match = rng.random(n) < density
        last = torch.cummax(torch.where(torch.from_numpy(match), torch.arange(n), -1), 0).values
        assert PT._last_true(torch.from_numpy(match)).tolist() == last.tolist()
        _eq(PT._merge_mask_device(torch.from_numpy(match)), JT._merge_mask_device(jnp.asarray(match)))
        new = np.where(rng.random(n) < density, -1, rng.integers(0, 300, n)).astype(np.int32)
        _eq(PT._compact(torch.from_numpy(new)), JT._compact(jnp.asarray(new)))


def test_count_shard_and_pick_best_equal_jax(meshes):
    jm, pm = meshes
    D, K = pm.size, 9
    for seed, alpha, empty in ((0, 3, ()), (1, 6, (2, 3)), (2, 9, (0, 7))):
        rng = np.random.default_rng(seed)
        flat = _shard_rows(rng, D, 37, alpha, empty=empty if D > 1 else ())
        jops = JT._make_shard_ops(K, D)
        pops = PT._make_shard_ops(K, pm)
        hist, occ = _jax(jops["count_shard"], jm, (P("data"),), (P("data"), P("data")), flat)
        ph, po = pops["count_shard"](_port_shards(flat, D))
        _eq(ph, hist)
        _eq(po, occ)

        def pick(ids):
            h, o = jops["count_shard"](ids)
            return jops["pick_best"](jax.lax.psum(h, "data"), jax.lax.pmax(o, "data"))

        want = _jax(pick, jm, (P("data"),), (P(), P(), P()), flat)
        got = pops["pick_best"](C.psum(ph), C.pmax(po))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("alpha", [2, 5, 40])
def test_count_pick_sorted_equal_jax(alpha):
    jm, pm = jax_mesh(1), data_mesh(1, device="cpu")
    rng = np.random.default_rng(alpha)
    for n, live in ((1, 1), (5, 3), (500, 500), (500, 321)):
        flat = _shard_rows(rng, 1, n, alpha, live=[live])
        want = _jax(JT._make_shard_ops(64, 1)["count_pick_sorted"], jm, (P("data"),), (P(), P(), P()), flat)
        got = PT._make_shard_ops(64, pm)["count_pick_sorted"](_port_shards(flat, 1))
        for g, w in zip(got, want):
            _eq(g, w)


@pytest.mark.parametrize("k_top", [2, 16, 1024])
def test_count_and_pick_candidates_equal_jax(meshes, k_top):
    """The candidate union, exact counts, owners, last positions and the
    bound; then the pick and its certificate.  ``_top_k`` orders ties as
    ``lax.top_k`` does, so even the uncertified picks agree."""
    jm, pm = meshes
    D = pm.size
    for seed, alpha, empty in ((0, 3, ()), (1, 5, (1, 2, 6)), (2, 12, (7,))):
        rng = np.random.default_rng(seed)
        flat = _shard_rows(rng, D, 61, alpha, empty=empty if D > 1 else ())
        jops = JT._make_shard_ops(2, D, k_top=k_top)
        pops = PT._make_shard_ops(2, pm, k_top=k_top)
        want = _jax(jops["count_candidates"], jm, (P("data"),), (P(),) * 6, flat)
        got = pops["count_candidates"](_port_shards(flat, D))
        for g, w in zip(got, want):
            _eq(g, w)
        want = _jax(lambda ids: jops["pick_candidates"](*jops["count_candidates"](ids)),
                    jm, (P("data"),), (P(),) * 4, flat)
        for g, w in zip(pops["pick_candidates"](*got), want):
            _eq(g, w)


@pytest.mark.parametrize("case", ["straddling-runs", "empty-shards", "random"])
def test_apply_merge_equal_jax(meshes, case):
    """Runs of the merged pair crossing shard boundaries (the carry
    chain), shards emptied late in training (the halo and the carry pass
    through them), and random shards; ids given as ints or 0-d tensors."""
    jm, pm = meshes
    D = pm.size
    rng = np.random.default_rng(7)
    if case == "straddling-runs":
        lives = [3, 4, 2, 5, 1, 6, 4, 2][:D]
        flat = np.concatenate([[5] * k + [-1] * (8 - k) for k in lives]).astype(np.int32)
        pairs = [(5, 5)]
    elif case == "empty-shards":
        flat = _shard_rows(rng, D, 9, 3, empty=(1, 2, 5, 6) if D > 1 else (), live=[9] * D)
        pairs = [(0, 1), (1, 1), (2, 0)]
    else:
        flat = _shard_rows(rng, D, 40, 3)
        pairs = [(0, 0), (1, 2)]
    pops = PT._make_shard_ops(12, pm)
    for id1, id2 in pairs:
        want = _jax(JT._make_shard_ops(12, D)["apply_merge"], jm, (P("data"), P(), P(), P()),
                    P("data"), flat, np.array([id1], np.int32), np.array([id2], np.int32),
                    np.array([11], np.int32))
        shards = _port_shards(flat, D)
        _eq(pops["apply_merge"](shards, id1, id2, 11), want)
        t1, t2 = torch.tensor(id1, dtype=torch.int32), torch.tensor(id2, dtype=torch.int32)
        _eq(pops["apply_merge"](shards, t1, t2, 11), want)
        _eq(torch.cat(shards), flat)  # the input shards are not written


@pytest.mark.parametrize("path", ["dense", "candidates"])
def test_scan_chunk_equals_jax(meshes, path):
    """One 32-merge chunk: the ids after it and every step's (id1, id2,
    count, ok), the steps past a stop included."""
    jm, pm = meshes
    D = pm.size
    rng = np.random.default_rng(3)
    flat = _shard_rows(rng, D, 120, 4, live=[120] * D)
    flat[-5:] = -1
    K = 300
    use = path == "candidates"
    j_scan, _f, _m = JT.make_scan_train_step(K, jm, 2, 32, use_candidates=use, k_top=8)
    p_scan, _f, _m = PT.make_scan_train_step(K, pm, 2, 32, use_candidates=use, k_top=8)
    j_ids, *j_stats = j_scan(jax.device_put(flat, jax.sharding.NamedSharding(jm, P("data"))), 256)
    p_ids, p_stats = p_scan(_port_shards(flat, D), 256)
    _eq(p_ids, j_ids)
    for row, want in zip(p_stats, j_stats):
        np.testing.assert_array_equal(row.numpy(), np.asarray(want).astype(np.int32))


# ------------------------------------------------------------- trainer


def _words_corpus(seed, alphabet, n_words, n_picks):
    rng = random.Random(seed)
    words = [
        "".join(rng.choice(alphabet) for _ in range(rng.randrange(1, 9)))
        for _ in range(n_words)
    ]
    return " ".join(rng.choice(words) for _ in range(n_picks)).encode()


def _tie_free():
    words = [b"aluminium", b"borostyan", b"cseresznye", b"dinnye", b"eper", b"fuge", b"galagonya"]
    return b"".join(w + b" " for i, w in enumerate(words) for _ in range(200 - 23 * i))


def _gpt2_scale():
    rng = np.random.default_rng(11)
    words = ["".join(map(chr, rng.integers(97, 122, rng.integers(2, 10)))) for _ in range(300)]
    return " ".join(rng.choice(words, 3000).tolist()).encode()


def _fuzz(trial):
    rng = np.random.default_rng(123)
    for _ in range(trial + 1):
        alpha = int(rng.integers(2, 7))
        n = int(rng.integers(40, 1200))
        corpus = bytes((97 + rng.integers(0, alpha, n)).astype(np.uint8))
        vs = 256 + int(rng.integers(4, 60))
    return corpus, vs


# name -> (corpus, vocab size, forced candidates, k_top): the corpora of
# tests/test_parallel.py, the fuzz draws included
CASES = {
    "cat": (lambda: b"the cat sat on the mat " * 32, 280, False, None),
    "boundary-runs": (lambda: b"ab" * 203 + b"xy" + b"a" * 37, 262, False, None),
    "tie-free": (_tie_free, 280, False, None),
    **{f"words-{t}": (lambda t=t: _words_corpus(77 + t, "abcdeé ", 60, 500), 300, False, None)
       for t in range(2)},
    **{f"candidates-{t}": (lambda t=t: _words_corpus(5 + t, "abcdef ", 50, 600), 300, True, None)
       for t in range(2)},
    "tiny-k": (lambda: b"the cat sat on the mat and the dog ate the cat food " * 20, 290, True, 2),
    "gpt2-vocab": (_gpt2_scale, 50257, False, None),
    **{f"fuzz-{t}": (lambda t=t: _fuzz(t)[0], None, True, None) for t in range(4)},
}


def _case(name):
    make, vs, force, k_top = CASES[name]
    corpus = make()
    return corpus, (vs if vs is not None else _fuzz(int(name.split("-")[1]))[1]), force, k_top


def _train(module, corpus, vs, mesh, monkeypatch, force, k_top, ckpt):
    monkeypatch.setenv("HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES", "1" if force else "0")
    if k_top is not None:
        orig = module.make_scan_train_step

        def tiny_k(K, mesh_, min_merge_count, scan_steps, use_candidates=False):
            return orig(K, mesh_, min_merge_count, scan_steps,
                        use_candidates=use_candidates, k_top=k_top)

        monkeypatch.setattr(module, "make_scan_train_step", tiny_k)
    vocab = module.distributed_bbpe_train(corpus, vs, mesh=mesh, verbose=False, checkpoint_path=ckpt)
    monkeypatch.undo()
    return vocab, open(ckpt + ".merges", encoding="utf-8").read()


@pytest.mark.parametrize("name", list(CASES))
def test_trainer_equals_jax_and_host(meshes, name, tmp_path, monkeypatch):
    """Vocab and merge log equal to JAX's distributed trainer on the
    same shard count and to ``bbpe_train_core``, on every corpus: dense,
    forced candidates, tiny k (rollback and the exact host pick) and
    vocab 50,257 (candidates, since K^2 passes the dense limit)."""
    jm, pm = meshes
    corpus, vs, force, k_top = _case(name)
    log = []
    host = bbpe_train_core(corpus, vs, verbose=False, merge_log=log)
    host_log = "".join(f"{a} {b} {c}\n" for a, b, c in log)
    got, got_log = _train(PT, corpus, vs, pm, monkeypatch, force, k_top, str(tmp_path / "p.txt"))
    assert got == host and got_log == host_log
    if name == "gpt2-vocab" and pm.size == 1:
        return  # JAX's 1-device run takes 11 s here; the 8-device run is compared
    want, want_log = _train(JT, corpus, vs, jm, monkeypatch, force, k_top, str(tmp_path / "j.txt"))
    assert got == want and got_log == want_log
    assert open(tmp_path / "p.txt", "rb").read() == open(tmp_path / "j.txt", "rb").read()


@pytest.mark.parametrize("corpus", [b"", b"a", b"ab", b"aaa"])
def test_trainer_on_tiny_corpora(corpus):
    for n in (1, 8):
        assert PT.distributed_bbpe_train(
            corpus, 300, mesh=data_mesh(n, device="cpu"), verbose=False
        ) == bbpe_train_core(corpus, 300, verbose=False)


def test_checkpoint_and_resume_match_straight_run(tmp_path):
    """As tests/test_checkpoint.py, on 8 CPU shards; the checkpoint files
    equal the JAX trainer's."""
    mesh = data_mesh(8, device="cpu")
    corpus = b"the cat sat on the mat and a dog dug a rug " * 24
    straight = PT.distributed_bbpe_train(corpus, 300, mesh=mesh, verbose=False)
    ck, jck = str(tmp_path / "ckpt.txt"), str(tmp_path / "jax.txt")
    PT.distributed_bbpe_train(corpus, 280, mesh=mesh, verbose=False, checkpoint_path=ck, checkpoint_every=8)
    JT.distributed_bbpe_train(corpus, 280, mesh=jax_mesh(8), verbose=False, checkpoint_path=jck,
                              checkpoint_every=8)
    for suffix in ("", ".merges"):
        assert open(ck + suffix, "rb").read() == open(jck + suffix, "rb").read()
    resumed = PT.distributed_bbpe_train(corpus, 300, mesh=mesh, verbose=False, checkpoint_path=ck,
                                        resume=True)
    assert resumed == straight == bbpe_train_core(corpus, 300, verbose=False)


def test_facade_writes_the_jax_facades_file(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    text = ft.CORPUS[:3000]
    got = PF.bbpe_train(text, 330, "port.txt", verbose=False, mesh=data_mesh(8, device="cpu"))
    want = J.bbpe_train(text, 330, "jax.txt", verbose=False, mesh=jax_mesh(8))
    host = PF.bbpe_train(text, 330, "host.txt", verbose=False)
    assert open(got, "rb").read() == open(want, "rb").read() == open(host, "rb").read()


def test_mesh_refusals(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    with pytest.raises(TypeError, match="DataMesh"):
        PF.bbpe_train("abc abc", 300, "v.txt", mesh=jax_mesh(1))
    with pytest.raises(TypeError, match="DataMesh"):
        PF.bpe_train("abc abc", 300, "v.txt", mesh=jax_mesh(1))
    with pytest.raises(ValueError, match="at least one shard"):
        data_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="cuda"):
        data_mesh(2, device="tpu")


def test_data_mesh_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for args in ((), (1,), (4,)):
        with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
            data_mesh(*args)


def test_shard_batch_and_collectives():
    mesh = data_mesh(3, device="cpu")
    assert isinstance(mesh, DataMesh) and mesh.size == 3
    shards = shard_batch(mesh, np.arange(7, dtype=np.int32))
    assert [s.tolist() for s in shards] == [[0, 1, 2], [3, 4, 5], [6, -1, -1]]
    assert C.all_gather(shards).tolist() == [[0, 1, 2], [3, 4, 5], [6, -1, -1]]
    assert C.psum(shards).tolist() == [9, 4, 6] and C.psum(shards).dtype == torch.int32
    assert C.pmax(shards).tolist() == [6, 4, 5]
    assert list(C.axis_index(mesh)) == [0, 1, 2]
    one = shard_batch(data_mesh(1, device="cpu"), torch.arange(4, dtype=torch.int32))
    assert C.psum(one) is one[0] and C.pmax(one) is one[0]
    assert C.all_gather(one).data_ptr() == one[0].data_ptr()  # a view


# ---------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 4])
def test_trainer_on_the_card_equals_host(shards, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = data_mesh(shards)
    assert all(d.type == "cuda" for d in mesh.devices)
    corpus, vs, _force, _k = _case("candidates-0")
    want = bbpe_train_core(corpus, vs, verbose=False)
    for force in ("0", "1"):
        monkeypatch.setenv("HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES", force)
        assert PT.distributed_bbpe_train(corpus, vs, mesh=mesh, verbose=False) == want


@pytest.mark.cuda
def test_chunk_makes_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = data_mesh()
    scan, _f, _m = PT.make_scan_train_step(1300, mesh, 2, 32)
    ids = shard_batch(mesh, np.frombuffer(_case("cat")[0] * 40, np.uint8).astype(np.int32))
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ids, stats = scan(ids, 256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert stats.shape == (4, 32) and int(stats[2, 0]) > 1
