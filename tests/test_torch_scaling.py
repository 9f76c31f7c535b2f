"""Weak-scaling properties of sharded encode in the PyTorch port (the
counterpart of ``tests/test_scaling.py``), on CPU shards
(``data_mesh(n, "cpu")``), which share the host's cores as JAX's virtual
devices do, so wall-clock scaling is not asserted here:

* exactness: ``sharded_merge_words`` gives the same ids at mesh sizes 1,
  2, 4 and 8, equal to the JAX package's on as many virtual devices;
* structural weak scaling: at a constant number of rows per shard every
  shard gets exactly that many rows, so no work is replicated;
* the mesh engine at each size equals the one-device engine and the
  native host engine, every shard merging blocks.

Ids are integers: every comparison is exact (tolerance 0)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch_parity as tp  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.corpora import build_unique_corpus  # noqa: E402
from hutoken_tpu_torch.native import NativeEngine  # noqa: E402
from hutoken_tpu_torch.parallel import data_mesh, sharded_merge_words  # noqa: E402
from hutoken_tpu_torch.parallel.sharded import row_slices  # noqa: E402
from hutoken_tpu_torch.scripts.common import load_ctx  # noqa: E402

torch.set_num_threads(1)

ROWS_PER_DEV = 512
LANES = 32
SIZES = (1, 2, 4, 8)


def _block(rows):
    rng = np.random.RandomState(7)
    return rng.randint(0, 256, size=(rows, LANES)).astype(np.int32)


@pytest.fixture(scope="module")
def base():
    tab = tp.device_tables_cpu("small")
    return np.concatenate([o.numpy() for o in sharded_merge_words(tab, data_mesh(1, "cpu"),
                                                                   _block(ROWS_PER_DEV * 8))])


@pytest.mark.parametrize("n", SIZES)
def test_sharded_exact_across_mesh_sizes(n, base):
    """The same block at every mesh size gives the same ids, and the JAX
    package's on ``n`` virtual devices."""
    import jax
    import jax.numpy as jnp

    from hutoken_tpu.engine import TpuTokenizer
    from hutoken_tpu.parallel.mesh import data_mesh as jax_data_mesh
    from hutoken_tpu.parallel.sharded import sharded_merge_words as jax_sharded

    block = _block(ROWS_PER_DEV * 8)
    tab = tp.device_tables_cpu("small")
    out = np.concatenate([o.numpy() for o in sharded_merge_words(tab, data_mesh(n, "cpu"), block)])
    assert np.array_equal(out, base), f"mesh size {n} changed the output"
    if len(jax.devices()) < n:
        pytest.skip(f"needs {n} JAX devices")
    ctx, _enc = tp.load("small")
    want = np.asarray(jax_sharded(TpuTokenizer(ctx).table_arrays, jax_data_mesh(n), jnp.asarray(block)))
    assert np.array_equal(out, want)


@pytest.mark.parametrize("n", SIZES)
def test_weak_scaling_rows_per_shard_flat(n):
    """Constant rows per shard: each shard's slice is exactly that long,
    and the slices tile the block in order."""
    slices = row_slices(ROWS_PER_DEV * n, data_mesh(n, "cpu"))
    assert [s.stop - s.start for s in slices] == [ROWS_PER_DEV] * n
    assert slices[0].start == 0 and all(a.stop == b.start for a, b in zip(slices, slices[1:]))
    tab = tp.device_tables_cpu("small")
    outs = sharded_merge_words(tab, data_mesh(n, "cpu"), _block(ROWS_PER_DEV * n))
    assert [tuple(o.shape) for o in outs] == [(ROWS_PER_DEV, LANES)] * n


@pytest.mark.parametrize("n", SIZES)
def test_mesh_engine_exact_across_mesh_sizes(n, monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    pctx = load_ctx("small")
    docs = build_unique_corpus(0.02 * n, seed=n)
    tok = E.TorchTokenizer(pctx, mesh=data_mesh(n, "cpu"))
    got = tok.encode_batch(docs)
    assert got == E.TorchTokenizer(pctx, device="cpu").encode_batch(docs)
    assert got == NativeEngine(pctx).encode_batch(docs, 2)
    assert min(tok.stat_shard_fused) > 0
