"""Sharded encode in the PyTorch port (``hutoken_tpu_torch/parallel/
sharded.py`` and ``TorchTokenizer(..., mesh=)``) on CPU shards, against
the JAX package on its 8 virtual CPU devices, the port on one device
and the native engine.  Token ids are integers: every comparison is
exact (tolerance 0).

The port's blocks are cut to 64 / 16 rows, as in
``tests/test_torch_engine.py``, so that small batches fill whole blocks
and every shard merges rows of both buckets (the fused twin for words
of up to 32 bytes, the eager fixed point for 33-128).  Tests marked
``cuda`` run the same on the card and skip here."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.corpora import build_corpus, build_unique_corpus  # noqa: E402
from hutoken_tpu_torch.native import NativeEngine  # noqa: E402
from hutoken_tpu_torch.ops.merge import merge_fixed_point  # noqa: E402
from hutoken_tpu_torch.parallel import DataMesh, data_mesh, sharded_merge_words  # noqa: E402
from hutoken_tpu_torch.parallel.sharded import replicas, row_slices  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _jax_mesh(n: int):
    import jax

    from hutoken_tpu.parallel.mesh import data_mesh as jax_data_mesh

    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    return jax_data_mesh(n)


def _long_words(rng, n: int) -> list[str]:
    """Words of 33-128 bytes: the eager bucket."""
    letters = list("abcdefghijklmnopáéő")
    return ["".join(rng.choice(letters, int(rng.integers(33, 100)))) for _ in range(n)]


def _docs(corpus: str) -> list[str]:
    """A small Zipf or unique corpus (``corpora.py``), with long words
    spliced into every fourth document and a few edge documents."""
    rng = np.random.default_rng(7)
    docs = build_corpus(0.03, seed=3) if corpus == "zipf" else build_unique_corpus(0.03, seed=4)
    docs = [d + " " + " ".join(_long_words(rng, 3)) if i % 4 == 0 else d for i, d in enumerate(docs)]
    return docs + ["", " ", "x", " leading space"]


def _block(seed: int, rows: int = 64, width: int = 16) -> np.ndarray:
    """Random byte seeds, each row -1-padded past a random length."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, 256, size=(rows, width)).astype(np.int32)
    lens = rng.integers(0, width + 1, rows)
    block[np.arange(width)[None, :] >= lens[:, None]] = -1
    return block


# ------------------------------------------------- sharded_merge_words


@pytest.mark.parametrize("name", ["small", "big-merges"])
def test_sharded_merge_words_matches_jax_and_one_shard(name):
    import jax.numpy as jnp

    from hutoken_tpu.engine import TpuTokenizer
    from hutoken_tpu.parallel.sharded import sharded_merge_words as jax_sharded

    ctx, _enc = tp.load(name)
    tab = tp.device_tables_cpu(name)
    block = _block(0)
    want = np.asarray(jax_sharded(TpuTokenizer(ctx).table_arrays, _jax_mesh(8), jnp.asarray(block)))
    got = sharded_merge_words(tab, data_mesh(8, device="cpu"), block)
    assert len(got) == 8 and all(g.shape == (8, 16) for g in got)
    assert np.array_equal(torch.cat(got).numpy(), want)
    one = merge_fixed_point(tab, torch.from_numpy(block)).numpy()
    assert np.array_equal(one, want)
    # rows that do not divide over the mesh: 21, 21, 22
    three = sharded_merge_words(tab, data_mesh(3, device="cpu"), torch.from_numpy(block))
    assert [g.shape[0] for g in three] == [21, 21, 22]
    assert np.array_equal(torch.cat(three).numpy(), want)


def test_row_slices_and_replicas():
    mesh = data_mesh(3, device="cpu")
    assert row_slices(64, mesh) == [slice(0, 21), slice(21, 42), slice(42, 64)]
    assert row_slices(2, mesh) == [slice(0, 0), slice(0, 1), slice(1, 2)]
    # a process of a 2-process mesh takes its own shards' slices
    far = DataMesh((torch.device("cpu"),) * 2, process_index=1, process_count=2)
    assert far.size == 4 and list(far.local_shards) == [2, 3]
    assert row_slices(10, far) == [slice(5, 7), slice(7, 10)]
    tab = tp.device_tables_cpu("small")
    reps = replicas(tab, mesh)
    assert len(reps) == 3 and all(r is tab for r in reps)  # one device, one copy


def test_sharded_merge_words_refuses_bad_input():
    tab = tp.device_tables_cpu("small")
    with pytest.raises(TypeError, match="DataMesh"):
        sharded_merge_words(tab, [torch.device("cpu")], _block(1))
    with pytest.raises(ValueError, match=r"\[W, L\]"):
        sharded_merge_words(tab, data_mesh(2, device="cpu"), np.zeros(8, np.int32))


# ------------------------------------------------------- sharded engine


@pytest.mark.parametrize("corpus", ["zipf", "unique"])
@pytest.mark.parametrize("name", ["small", "big-merges"])
def test_sharded_engine_matches_jax_single_and_native(name, corpus):
    from hutoken_tpu.engine import TpuTokenizer

    ctx, _enc = tp.load(name)
    docs = _docs(corpus)
    sharded = E.TorchTokenizer(ctx, device="cpu", mesh=data_mesh(8, "cpu"))
    got = sharded.encode_batch(docs)
    assert got == TpuTokenizer(ctx, mesh=_jax_mesh(8)).encode_batch(docs)
    assert got == E.TorchTokenizer(ctx, device="cpu").encode_batch(docs)
    assert got == NativeEngine(ctx).encode_batch(docs, 2)
    assert sharded.stat_device_words > 0 and sharded.stat_flagged_words == 0
    assert min(sharded.stat_shard_fused) > 0, sharded.stat_shard_fused
    flat, offs = sharded.encode_batch_arrays(docs)
    assert [flat[offs[i] : offs[i + 1]].tolist() for i in range(len(docs))] == got


@pytest.mark.parametrize("name", ["small", "big-merges", "charmode"])
def test_three_shard_engine_matches_one_device(name):
    """Rows that do not divide over the mesh, on the byte path and (for
    charmode) the id path, warm and cold."""
    ctx, _enc = tp.load(name)
    docs = _docs("unique")
    one = E.TorchTokenizer(ctx, device="cpu")
    three = E.TorchTokenizer(ctx, mesh=data_mesh(3, "cpu"))
    assert three.device == torch.device("cpu")
    want = one.encode_batch(docs)
    assert three.encode_batch(docs) == want
    assert three.stat_device_words > 0
    three.reset_cache()
    assert three.encode_batch(docs) == want


def test_python_core_under_a_mesh(monkeypatch):
    """Without the native splitter the engine takes _encode_core_py,
    which launches through the same sharded blocks."""
    ctx, _enc = tp.load("big-merges")
    docs = _docs("zipf")
    want = E.TorchTokenizer(ctx, device="cpu").encode_batch(docs)
    sharded = E.TorchTokenizer(ctx, device="cpu", mesh=data_mesh(4, "cpu"))
    sharded._native_split_ok = False
    assert sharded.encode_batch(docs) == want
    assert min(sharded.stat_shard_fused) > 0


def test_raw_env_keeps_the_word_pipeline_under_a_mesh(monkeypatch):
    monkeypatch.setenv("HUTOKEN_TPU_RAW", "1")
    ctx, _enc = tp.load("big-merges")
    docs = _docs("unique")
    want = E.TorchTokenizer(ctx, device="cpu").encode_batch(docs)
    sharded = E.TorchTokenizer(ctx, device="cpu", mesh=data_mesh(2, "cpu"))

    def no_raw(_texts):
        raise AssertionError("the raw path ran under a mesh")

    monkeypatch.setattr(sharded, "_encode_core_raw", no_raw)
    assert sharded.encode_batch(docs) == want
    assert sharded.stat_device_words > 0


def test_engine_refuses_foreign_and_mismatched_meshes():
    ctx, _enc = tp.load("small")
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="processes"):
        E.TorchTokenizer(ctx, device="cpu", mesh=DataMesh((cpu,) * 4, 0, 2))
    with pytest.raises(TypeError, match="DataMesh"):
        E.TorchTokenizer(ctx, device="cpu", mesh=(cpu, cpu))
    with pytest.raises(TypeError, match="device= or mesh="):
        E.TorchTokenizer(ctx)
    with pytest.raises(ValueError, match="mesh's type"):
        E.TorchTokenizer(ctx, device="cuda", mesh=data_mesh(2, "cpu"))


# ---------------------------------------------------------- on the card


@pytest.mark.cuda
def test_sharded_engine_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hutoken_tpu_torch.ops.fused_merge import merge_words_from_bytes_fused as fused

    ctx, _enc = tp.load("big-merges")
    docs = _docs("zipf")
    want = E.TorchTokenizer(ctx, device="cuda").encode_batch(docs)
    sharded = E.TorchTokenizer(ctx, mesh=data_mesh(2))
    before = fused.launches
    assert sharded.encode_batch(docs) == want
    assert min(sharded.stat_shard_fused) > 0
    assert fused.launches - before == sum(sharded.stat_shard_fused)


@pytest.mark.cuda
def test_sharded_merge_words_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    tab = tp.device_tables_cpu("big-merges")
    block = _block(2, rows=1000)
    want = merge_fixed_point(tab, torch.from_numpy(block))
    got = sharded_merge_words(tab, data_mesh(4), block)
    assert all(g.device.type == "cuda" for g in got)
    assert torch.equal(torch.cat([g.cpu() for g in got]), want)
