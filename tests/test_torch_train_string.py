"""The port's device string (spelling-group) trainer
(hutoken_tpu_torch/parallel/train.py) against the JAX package's, on the
CPU, tolerance 0 (integers): the two shard ops it ports, its steps and
one speculative chunk under ``shard_map`` on the 8-device CPU mesh of
tests/conftest.py (or a 1-device one); its device exact pick against
the reference's host pick, and under hash collisions; the witness of
the reference's duplicate-row count in the deep pick; the host merge
past ``MAXC``; tiny corpora; the facade.  The trainer on the corpora of
tests/test_parallel.py is in tests/test_torch_train_string_runs.py and
tests/test_torch_train_string_loop.py.  Tests marked ``cuda`` run on
the card and skip here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from jax.sharding import NamedSharding  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

import fixture_tools as ft  # noqa: E402
import hutoken_tpu as J  # noqa: E402
import hutoken_tpu.parallel.train as JT  # noqa: E402
import hutoken_tpu_torch as PF  # noqa: E402
import hutoken_tpu_torch.parallel.train as PT  # noqa: E402
from hutoken_tpu.parallel.mesh import data_mesh as jax_mesh  # noqa: E402
from hutoken_tpu_torch.parallel import data_mesh, shard_batch  # noqa: E402
from hutoken_tpu_torch.train.bpe import bpe_train_core  # noqa: E402
from test_torch_train import _eq, _jax, _port_shards, _shard_rows, meshes  # noqa: E402,F401

torch.set_num_threads(1)

ABAB = (b"abab" * 200) + (b"aab" * 100)  # tests/test_parallel.py:138


def _comps(pairs):
    """``(c1, c2)``: int32 ``[MAXC]``, -1-padded, as the driver sends."""
    c1 = np.full(PT.MAXC, -1, np.int32)
    c2 = np.full(PT.MAXC, -1, np.int32)
    for j, (u, v) in enumerate(pairs):
        c1[j], c2[j] = u, v
    return c1, c2


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _jax_ids(flat, jm):
    return jax.device_put(flat, NamedSharding(jm, P("data")))


def shallow(monkeypatch, module, depth):
    """Cut every candidate table of ``module``'s string trainer to
    ``depth`` rows a shard but the deep table's ``DEEP_K``, through the
    module's ``_make_shard_ops``, which every step builder calls."""
    orig = module._make_shard_ops

    def cut(K, mesh, k_top=1024):
        return orig(K, mesh, k_top=k_top if k_top == 32768 else depth)

    monkeypatch.setattr(module, "_make_shard_ops", cut)


class _Largest(TorchDispatchMode):
    """The element count of the largest tensor an op returns."""

    def __init__(self):
        super().__init__()
        self.numel = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor):
                self.numel = max(self.numel, t.numel())
        return out


# ------------------------------------------------------------ shard ops


@pytest.mark.parametrize("case", ["one", "three", "maxc", "straddling-runs", "empty-shards"])
def test_apply_merge_multi_equals_jax(meshes, case):
    """1, 3 and ``MAXC`` compositions, runs of a composition crossing
    shard boundaries (the carry chain) and shards emptied late in
    training; the op builds no ``[MAXC, n]`` tensor and writes no input."""
    jm, pm = meshes
    D = pm.size
    rng = np.random.default_rng(11)
    n = 40
    if case == "straddling-runs":
        n = 8
        lives = [3, 4, 2, 5, 1, 6, 4, 2][:D]
        flat = np.concatenate([[5] * k + [-1] * (n - k) for k in lives]).astype(np.int32)
        comps = [(5, 5)]
    elif case == "empty-shards":
        n = 9
        flat = _shard_rows(rng, D, n, 3, empty=(1, 2, 5, 6) if D > 1 else (), live=[n] * D)
        comps = [(0, 1), (1, 1), (2, 0)]
    else:
        flat = _shard_rows(rng, D, n, 8)
        comps = {
            "one": [(1, 2)],
            "three": [(0, 0), (1, 2), (3, 1)],
            "maxc": [(u, v) for u in range(8) for v in range(8)],
        }[case]
    assert len(comps) <= PT.MAXC
    c1, c2 = _comps(comps)
    new_id = np.array([11], np.int32)
    want = _jax(JT._make_shard_ops(2, D)["apply_merge_multi"], jm, (P("data"), P(), P(), P()),
                P("data"), flat, c1, c2, new_id)
    shards = _port_shards(flat, D)
    with _Largest() as seen:
        got = PT._make_shard_ops(2, pm)["apply_merge_multi"](shards, *_t(c1, c2), 11)
    _eq(got, want)
    assert seen.numel < PT.MAXC * n
    _eq(torch.cat(shards), flat)


def _queries(flat, D, rng):
    """``PROBE_P`` query pairs: pairs of the stream, the halo pairs
    (a shard's last live id and the next non-empty shard's first),
    absent pairs, pads, half pads, and duplicates of all of them."""
    stream = flat[flat >= 0]
    inner = list(zip(stream[:-1].tolist(), stream[1:].tolist()))
    rows = flat.reshape(D, -1)
    live = [r[r >= 0] for r in rows]
    halo = []
    for s in range(D):
        nxt = [t for t in range(s + 1, D) if live[t].size]
        if live[s].size and nxt:
            halo.append((int(live[s][-1]), int(live[nxt[0]][0])))
    qs = halo + inner[:12] + [(7, 7), (0, 9), (-1, -1), (3, -1), (-1, 2)]
    qs = qs + qs[: PT.PROBE_P - len(qs)]
    qs = [qs[i] for i in rng.permutation(len(qs))] + [(-1, -1)] * (PT.PROBE_P - len(qs))
    qa = np.array([a for a, _b in qs], np.int32)
    qb = np.array([b for _a, b in qs], np.int32)
    return qa, qb


@pytest.mark.parametrize("seed", [0, 1])
def test_probe_pairs_equals_jax(meshes, seed):
    """Exact count, last shard and last local position of present,
    halo, absent, pad and duplicate queries; no ``[PROBE_P, n]`` tensor."""
    jm, pm = meshes
    D = pm.size
    rng = np.random.default_rng(seed)
    n = 70
    flat = _shard_rows(rng, D, n, 4, empty=(2, 5) if D > 1 else ())
    qa, qb = _queries(flat, D, rng)
    want = _jax(JT._make_shard_ops(2, D)["probe_pairs"], jm, (P("data"), P(), P()),
                (P(), P(), P()), flat, qa, qb)
    with _Largest() as seen:
        got = PT._make_shard_ops(2, pm)["probe_pairs"](_port_shards(flat, D), *_t(qa, qb))
    for g, w in zip(got, want):
        _eq(g, w)
    assert seen.numel < PT.PROBE_P * n
    assert int(got[0].max()) > 1 and int(got[0].min()) == 0


def _hash(spelling):
    """The driver's spelling hash, H(s) = sum (s[i] + 1) * P^i mod 2^64."""
    h, p = np.uint64(0), np.uint64(1)
    with np.errstate(over="ignore"):
        for c in spelling:
            h, p = h + p * np.uint64(c + 1), p * PT.SPELL_HASH_P
    return h


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_group_pick_equals_host_pick(shards):
    """The device exact pick against ``_host_exact_string_pick`` (the
    reference's host pick, copied): the winning spelling (its pairs all
    spell it), count and last (shard, position), on random states with
    composed spellings and empty shards."""
    rng = np.random.default_rng(shards)
    ops = PT._make_shard_ops(2, data_mesh(shards, device="cpu"))
    for _ in range(40):
        spells = [bytes([i]) for i in range(256)]
        pool = [97, 98, 99]
        for _ in range(6):
            s = spells[int(rng.choice(pool))] + spells[int(rng.choice(pool))]
            if s not in spells:
                spells.append(s)
                pool.append(len(spells) - 1)
        flat = _shard_rows(rng, shards, 25, 1, empty=(1,) if shards > 1 else ())
        flat = np.where(flat >= 0, rng.choice(pool, flat.shape), -1).astype(np.int32)
        gh = np.array([_hash(s) for s in spells], np.uint64)
        gp = np.array([PT.SPELL_HASH_P ** np.uint64(len(s)) for s in spells], np.uint64)
        got = ops["group_pick"](_port_shards(flat, shards), *_t(gh.view(np.int64), gp.view(np.int64)))
        want = PT._host_exact_string_pick(flat, spells)
        if want is None:
            assert got is None
            continue
        cnt, last, pairs = got
        assert {spells[int(k) >> 31] + spells[int(k) & PT.ID_MASK] for k in pairs} == {want[0]}
        n = flat.shape[0] // shards
        stream_pos = np.flatnonzero(flat >= 0)  # global position of each stream element
        assert cnt == want[1][0]
        assert (last >> 32) * n + (last & 0xFFFFFFFF) == stream_pos[want[1][1]]


# ---------------------------------------------------------------- steps


def _corpus_ids(D):
    """The abab corpus's first bytes, -1-padded to a multiple of D."""
    ids = np.frombuffer(ABAB[:301] + b" aab", np.uint8).astype(np.int32)
    return np.concatenate([ids, np.full((-ids.size) % D, -1, np.int32)])


@pytest.mark.parametrize("k_top", [2, 8192])
def test_string_steps_equal_jax(meshes, k_top):
    """``string_step``'s ids and packed stats (after a merge and with
    none pending), ``merge_multi_step`` and ``probe_step``."""
    jm, pm = meshes
    D = pm.size
    flat = _corpus_ids(D)
    j_step, j_multi, j_probe = JT.make_string_step(jm, k_top=k_top)
    p_step, p_multi, p_probe = PT.make_string_step(pm, k_top=k_top)
    j_ids, p_ids = _jax_ids(flat, jm), _port_shards(flat, D)
    for comps, new_id in (([(97, 98)], 256), ([], 0), ([(256, 256), (97, 256)], 257)):
        c1, c2 = _comps(comps)
        j_ids, j_packed = j_step(j_ids, c1, c2, new_id)
        p_ids, p_packed = p_step(p_ids, *_t(c1, c2), new_id)
        _eq(p_ids, j_ids)
        _eq(p_packed, j_packed)
    c1, c2 = _comps([(256, 97), (98, 257)])
    _eq(p_multi(p_ids, *_t(c1, c2), 258), j_multi(j_ids, c1, c2, 258))
    qa, qb = _queries(np.asarray(j_ids), D, np.random.default_rng(3))
    for g, w in zip(p_probe(p_ids, *_t(qa, qb)), j_probe(j_ids, qa, qb)):
        _eq(g, w)


@pytest.mark.parametrize("k_top", [2, 8192])
def test_string_scan_chunk_equals_jax(meshes, k_top):
    """One speculative chunk: the ids after it and every sub-step's row
    (candidates, watch-list probe, bound, pick), the sub-steps past the
    last pair included."""
    jm, pm = meshes
    D = pm.size
    S = 6
    flat = _corpus_ids(D)
    flat[-40:] = np.where(flat[-40:] >= 0, 120, -1)  # runs of one id: the chunk empties them
    qa, qb = _comps([(97, 98), (98, 97), (120, 120), (97, 97), (258, 97)])
    j_ids, j_rows = JT.make_string_scan_step(jm, S, k_top=k_top)(_jax_ids(flat, jm), 256, qa, qb)
    p_ids, p_rows = PT.make_string_scan_step(pm, S, k_top=k_top)(_port_shards(flat, D), 256,
                                                                 *_t(qa, qb))
    _eq(p_ids, j_ids)
    _eq(p_rows, j_rows)


# -------------------------------------------------------------- trainer


def _by_id(vocab):
    return {i: sorted(s for s, j in vocab.items() if j == i) for i in set(vocab.values())}


def test_witness_reference_deep_pick_counts_duplicate_rows(monkeypatch):
    """The JAX trainer's fault that the port does not copy.  On 4 shards,
    with the per-merge loop (``HUTOKEN_TPU_STRING_SCAN=0``) and its
    candidate tables cut to 2 rows a shard, every pick falls to the deep
    table, whose union lists a pair once per shard that holds it in its
    top-k.  The reference's ``self_pick`` sums those rows
    (``hutoken_tpu/parallel/train.py:1141-1158``): b"abababab" counts
    597 at merge 2 (199 exact), and id 260 goes to b"abababababababab"
    where the host trainer gives it to b"aab".  The port drops the
    duplicate rows and equals ``bpe_train_core(strict=False)``."""
    monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", "0")
    host = bpe_train_core(ABAB, 300, strict=False, verbose=False)
    shallow(monkeypatch, PT, 2)
    shallow(monkeypatch, JT, 2)
    got = PT.distributed_bpe_train(ABAB, 300, mesh=data_mesh(4, device="cpu"), verbose=False)
    want = JT.distributed_bpe_train(ABAB, 300, mesh=jax_mesh(4), verbose=False)
    assert got == host
    host_ids, jax_ids = _by_id(host), _by_id(want)
    assert [host_ids[i] for i in range(257, 260)] == [jax_ids[i] for i in range(257, 260)]
    assert host_ids[260] == [b"aab"] and jax_ids[260] == [b"abababababababab"]


@pytest.mark.parametrize("scan", ["16", "0"])
def test_host_merge_past_maxc(scan, monkeypatch):
    """With ``MAXC`` set to 1 in both packages, every winner with two
    live compositions (b"abab" = ab+ab, a+bab, ...) merges on the host
    and reshards (``_host_apply_multi``); both equal the host core."""
    calls = {"port": 0, "jax": 0}
    for name, module in (("port", PT), ("jax", JT)):
        orig = module._host_apply_multi

        def counted(*args, orig=orig, name=name):
            calls[name] += 1
            return orig(*args)

        monkeypatch.setattr(module, "_host_apply_multi", counted)
        monkeypatch.setattr(module, "MAXC", 1)
    monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
    host = bpe_train_core(ABAB, 300, strict=False, verbose=False)
    for D in (1, 3):
        assert PT.distributed_bpe_train(ABAB, 300, mesh=data_mesh(D, device="cpu"), verbose=False) == host
        assert JT.distributed_bpe_train(ABAB, 300, mesh=jax_mesh(D), verbose=False) == host
    assert calls["port"] == calls["jax"] == 4


@pytest.mark.parametrize("scan", ["16", "0"])
def test_degenerate_hash_stays_exact(scan, monkeypatch):
    """With the spelling hash cut to its first byte (P = 0), nearly
    every group collides: the deep pick must punt and the device exact
    pick must fall back to the host pick, and the vocab stays exact."""
    calls = {"host": 0}
    orig = PT._host_exact_string_pick

    def counted(*args):
        calls["host"] += 1
        return orig(*args)

    monkeypatch.setattr(PT, "_host_exact_string_pick", counted)
    monkeypatch.setattr(PT, "SPELL_HASH_P", np.uint64(0))
    monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
    shallow(monkeypatch, PT, 2)
    host = bpe_train_core(ABAB, 300, strict=False, verbose=False)
    for D in (1, 4):
        assert PT.distributed_bpe_train(ABAB, 300, mesh=data_mesh(D, device="cpu"), verbose=False) == host
    assert calls["host"] > 0


@pytest.mark.parametrize("corpus", [b"", b"a", b"ab", b"aaa"])
def test_trainer_on_tiny_corpora(corpus, monkeypatch):
    want = bpe_train_core(corpus, 300, strict=False, verbose=False)
    for scan in ("16", "0"):
        monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
        for n in (1, 8):
            got = PT.distributed_bpe_train(corpus, 300, mesh=data_mesh(n, device="cpu"), verbose=False)
            assert got == want, (scan, n)


def test_facade_writes_the_jax_facades_file(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    text = ft.CORPUS[:3000]
    got = PF.bpe_train(text, 320, "port.txt", verbose=False, mesh=data_mesh(8, device="cpu"))
    want = J.bpe_train(text, 320, "jax.txt", verbose=False, mesh=jax_mesh(8))
    host = PF.bpe_train(text, 320, "host.txt", verbose=False, strict=False)
    assert open(got, "rb").read() == open(want, "rb").read() == open(host, "rb").read()


def test_trainer_refuses_other_meshes():
    for mesh in (jax_mesh(1), object()):
        with pytest.raises(TypeError, match="DataMesh"):
            PT.distributed_bpe_train(b"abc abc", 300, mesh=mesh, verbose=False)


# ---------------------------------------------------------- on the card


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 4])
def test_trainer_on_the_card_equals_host(shards, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = data_mesh(shards)
    assert all(d.type == "cuda" for d in mesh.devices)
    rng = np.random.default_rng(3)
    corpus = bytes(rng.integers(97, 103, 4000).astype(np.uint8))
    want = bpe_train_core(corpus, 300, strict=False, verbose=False)
    for scan in ("16", "0"):
        monkeypatch.setenv("HUTOKEN_TPU_STRING_SCAN", scan)
        assert PT.distributed_bpe_train(corpus, 300, mesh=mesh, verbose=False) == want
    shallow(monkeypatch, PT, 2)
    assert PT.distributed_bpe_train(corpus, 300, mesh=mesh, verbose=False) == want


@pytest.mark.cuda
def test_string_chunk_makes_no_host_sync():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    mesh = data_mesh()
    scan = PT.make_string_scan_step(mesh, 16, k_top=8192)
    ids = shard_batch(mesh, np.frombuffer(ABAB * 40, np.uint8).astype(np.int32))
    qa, qb = (t.cuda() for t in _t(*_comps([(97, 98), (98, 97)])))
    scan(ids, 256, qa, qb)  # warm, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _ids, rows = scan(ids, 256, qa, qb)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert rows.shape[0] == 16 and int(rows[0, -1]) > 1
