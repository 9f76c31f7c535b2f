"""The gather kernels (hutoken_tpu_torch/ops/gather.py), the probe that
runs them (hutoken_tpu_torch/scripts/profile_gather.py) and its timer
(``scripts/common.py::cuda_time``): each plain PyTorch twin against the
Pallas kernel it replaces, built as its script builds it but in
interpret mode, and against the script's own numpy oracle; the CUDA
kernels against their twins on the card.  Values are integers: every
comparison is exact.

The kernel bodies are closures inside each script's ``main()``, so they
are restated here with their file and line."""

import io
import itertools
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hutoken_tpu_torch.ops import build as B  # noqa: E402
from hutoken_tpu_torch.ops import gather as G  # noqa: E402
from hutoken_tpu_torch.scripts import common as SC  # noqa: E402
from hutoken_tpu_torch.scripts import profile_gather as PG  # noqa: E402

torch.set_num_threads(1)


# scripts/profile_pallas_gather.py:42-43
def k_take(table_ref, idx_ref, out_ref):
    out_ref[:] = jnp.take(table_ref[:], idx_ref[:], axis=0)


# scripts/profile_pallas_gather.py:70-75
def k_taa(table_ref, idx_ref, out_ref):
    t = table_ref[:].reshape(1, -1)
    out_ref[:] = jnp.take_along_axis(
        jnp.broadcast_to(t, (idx_ref.shape[0], t.shape[1])), idx_ref[:], axis=1
    )


# scripts/profile_pallas_gather2.py:64-72
def k_gather2(table_ref, idx_ref, out_ref):
    idx = idx_ref[:]
    rows = idx >> 7
    lanes = idx & 127
    t = table_ref[:]
    g = jnp.take_along_axis(t, rows, axis=0)
    out_ref[:] = jnp.take_along_axis(g, lanes, axis=1)


# scripts/profile_gather3.py:61-62
def kernel(r_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(r_ref[:], i_ref[:], axis=1)


# scripts/profile_gather3.py:98-99
def kernel0(t_ref, i_ref, o_ref):
    o_ref[:] = jnp.take_along_axis(t_ref[:], i_ref[:], axis=0)


def _vmem_call(body, table, idx):
    """run_take / run_taa / run2: whole arrays in VMEM, no grid
    (profile_pallas_gather.py:47-53, profile_pallas_gather2.py:76-82)."""
    return np.asarray(pl.pallas_call(
        body,
        out_shape=jax.ShapeDtypeStruct(idx.shape, jnp.int32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(table), jnp.asarray(idx)))


def _pallas_taa(R, idx, BLK):
    """pallas_taa (profile_gather3.py:64-79) without the final sum."""
    Wp, C2 = R.shape
    L = idx.shape[1]
    return np.asarray(pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((Wp, L), jnp.int32),
        grid=(Wp // BLK,),
        in_specs=[
            pl.BlockSpec((BLK, C2), lambda i: (i, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((BLK, L), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BLK, L), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(R), jnp.asarray(idx)))


def _pallas_g0(tbl, idx, BLK):
    """pallas_g0 (profile_gather3.py:101-116) without the final sum."""
    C = tbl.shape[0]
    N2 = idx.size
    return np.asarray(pl.pallas_call(
        kernel0,
        out_shape=jax.ShapeDtypeStruct((N2 // 128, 128), jnp.int32),
        grid=(N2 // 128 // BLK * 128 // 128,),
        in_specs=[
            pl.BlockSpec((C, 128), lambda i: (0, 0), memory_space=pltpu.VMEM),
            pl.BlockSpec((BLK, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((BLK, 128), lambda i: (i, 0), memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(tbl), jnp.asarray(idx)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("C,N", [(512, 256), (4096, 1024)])
def test_gather_1d_l2_matches_k_take(C, N):
    rng = np.random.default_rng(C + N)
    table = rng.integers(0, 1 << 20, C).astype(np.int32)
    idx_np = rng.integers(0, C, N).astype(np.int32)
    idx = idx_np.reshape(N // 128, 128)
    want = _vmem_call(k_take, table, idx)
    assert np.array_equal(want.reshape(-1), table[idx_np])  # the script's check
    got = G.gather_1d(_t(table), _t(idx), smem=False).numpy()
    assert got.dtype == np.int32 and np.array_equal(got, want)


@pytest.mark.parametrize("C,N", [(1024, 512), (8192, 1024)])
def test_gather_1d_smem_matches_k_taa(C, N):
    rng = np.random.default_rng(C * 3 + N)
    table = rng.integers(0, 1 << 20, C).astype(np.int32)
    idx_np = rng.integers(0, C, N).astype(np.int32)
    idx = idx_np.reshape(-1, 128)
    want = _vmem_call(k_taa, table, idx)
    assert np.array_equal(want.reshape(-1), table[idx_np])
    got = G.gather_1d(_t(table), _t(idx), smem=True).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("C,N", [(1024, 256), (8192, 1024), (32768, 512)])
def test_gather_two_level_matches_k_gather2(C, N):
    rng = np.random.default_rng(C + 7 * N)
    table_np = rng.integers(0, 1 << 20, C).astype(np.int32)
    table2d = table_np.reshape(C // 128, 128)
    idx_np = rng.integers(0, C, N).astype(np.int32)
    idxq = idx_np.reshape(N // 128, 128)
    want = _vmem_call(k_gather2, table2d, idxq)
    # the script's oracles (profile_pallas_gather2.py:90-94)
    rows = idxq >> 7
    lanes = idxq & 127
    composed = table_np.reshape(-1, 128)[np.take_along_axis(rows, lanes, axis=1), lanes]
    true_gather = table_np[idx_np].reshape(-1, 128)
    assert np.array_equal(want, composed)
    assert not np.array_equal(want, true_gather)  # random rows: not a gather
    got = G.gather_two_level(_t(table2d), _t(idxq)).numpy()
    assert np.array_equal(got, want)


def test_gather_two_level_is_a_true_gather_when_rows_repeat():
    """When every index of a 128-row shares its row (idx >> 7), the
    composed gather is the true gather: the script's "unless rows
    constant per row-block" remark."""
    rng = np.random.default_rng(5)
    C = 4096
    table_np = rng.integers(0, 1 << 20, C).astype(np.int32)
    row = rng.integers(0, C // 128, (8, 1))
    idx = (row * 128 + rng.integers(0, 128, (8, 128))).astype(np.int32)
    got = G.gather_two_level(_t(table_np.reshape(-1, 128)), _t(idx)).numpy()
    assert np.array_equal(got, table_np[idx])
    assert np.array_equal(got, _vmem_call(k_gather2, table_np.reshape(-1, 128), idx))


@pytest.mark.parametrize("C2,L", [(128, 32), (256, 32), (512, 8)])
def test_gather_rows_matches_pallas_taa(C2, L):
    rng = np.random.default_rng(C2 + L)
    Wp, BLK = 64, 16
    R = rng.integers(0, 1 << 16, (Wp, C2)).astype(np.int32)
    idx = rng.integers(0, C2, (Wp, L)).astype(np.int32)
    want = _pallas_taa(R, idx, BLK)
    assert np.array_equal(want, np.take_along_axis(R, idx, axis=1))
    assert np.array_equal(G.gather_rows(_t(R), _t(idx)).numpy(), want)


@pytest.mark.parametrize("W,BLK,C2,L", [(63, 21, 512, 5), (35, 7, 128, 33), (9, 9, 256, 1)])
@pytest.mark.parametrize("off", [0, 1, 3])
def test_gather_rows_matches_pallas_taa_on_ragged_shapes(W, BLK, C2, L, off):
    """Rows of 5, 33 and 1 indices, odd row counts, and index and table
    views at a 4-byte offset: the twin equals ``pallas_taa`` in interpret
    mode and numpy."""
    rng = np.random.default_rng(W + L + off)
    R = rng.integers(0, 1 << 16, (W, C2)).astype(np.int32)
    idx = rng.integers(0, C2, (W, L)).astype(np.int32)
    want = _pallas_taa(R, idx, BLK)
    assert np.array_equal(want, np.take_along_axis(R, idx, axis=1))
    R_t = torch.cat([torch.zeros(off, dtype=torch.int32), _t(R).reshape(-1)])[off:].view(W, C2)
    idx_t = torch.cat([torch.zeros(off, dtype=torch.int32), _t(idx).reshape(-1)])[off:].view(W, L)
    assert idx_t.data_ptr() % 16 == (4 * off) % 16 or off == 0
    assert np.array_equal(G.gather_rows(R_t, idx_t).numpy(), want)


@pytest.mark.parametrize("rows", [1, 5, 33])
@pytest.mark.parametrize("off", [0, 1])
def test_gather_two_level_matches_k_gather2_on_ragged_row_counts(rows, off):
    """Row counts that fill no warp group evenly, and an index view at a
    4-byte offset: the twin equals ``k_gather2`` in interpret mode and the
    script's composed numpy oracle."""
    rng = np.random.default_rng(rows * 10 + off)
    C = 8192
    table_np = rng.integers(0, 1 << 20, C).astype(np.int32)
    idxq = rng.integers(0, C, (rows, 128)).astype(np.int32)
    want = _vmem_call(k_gather2, table_np.reshape(-1, 128), idxq)
    composed = table_np.reshape(-1, 128)[np.take_along_axis(idxq >> 7, idxq & 127, axis=1),
                                         idxq & 127]
    assert np.array_equal(want, composed)
    flat = torch.cat([torch.zeros(off, dtype=torch.int32), _t(idxq).reshape(-1)])
    idx_t = flat[off:].view(rows, 128)
    got = G.gather_two_level(_t(table_np.reshape(-1, 128)), idx_t).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("C", [64, 512])
def test_gather_cols_matches_pallas_g0(C):
    rng = np.random.default_rng(C)
    N2, BLK = 128 * 64, 16
    tbl = np.broadcast_to(rng.integers(0, 1 << 16, (C, 1)).astype(np.int32), (C, 128)).copy()
    idx = rng.integers(0, C, (N2 // 128, 128)).astype(np.int32)
    want = _pallas_g0(tbl, idx, BLK)
    assert np.array_equal(want, np.take_along_axis(tbl, idx, axis=0))
    assert np.array_equal(G.gather_cols(_t(tbl), _t(idx)).numpy(), want)
    # a table whose columns differ: the lane picks its own column
    tbl2 = rng.integers(0, 1 << 16, (C, 128)).astype(np.int32)
    assert np.array_equal(G.gather_cols(_t(tbl2), _t(idx)).numpy(), _pallas_g0(tbl2, idx, BLK))


def test_entry_points_check_inputs_and_count_only_cuda_launches():
    t = torch.arange(256, dtype=torch.int32)
    i = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError, match="int32"):
        G.gather_1d(t.to(torch.int64), i, smem=False)
    with pytest.raises(ValueError, match="1-D"):
        G.gather_1d(t.reshape(2, 128), i, smem=True)
    with pytest.raises(ValueError, match=r"\[R, 128\]"):
        G.gather_two_level(t.reshape(4, 64), i)
    with pytest.raises(ValueError, match=r"\[W, C2\]"):
        G.gather_rows(t.reshape(2, 128), i[:1])
    with pytest.raises(ValueError, match=r"\[C, K\]"):
        G.gather_cols(t.reshape(4, 64), i)
    G.reset_launches()
    G.gather_1d(t, i, smem=True)
    G.gather_two_level(t.reshape(2, 128), i)
    G.gather_rows(t.reshape(2, 128), i)
    G.gather_cols(t.reshape(2, 128), i)
    assert (G.gather_two_level.launches, G.gather_rows.launches,
            G.gather_cols.launches) == (0, 0, 0)
    assert G.gather_1d.launches_by_mode == {"l2": 0, "smem": 0}
    assert G.gather_cols.launches_by_route == {"slab": 0, "l2": 0}


H100_SMS = 132
H100_SMEM = 232_448  # bytes a block may opt in to


def _h100_blocks_per_sm(smem_bytes: int) -> int:
    """gather_1d blocks of 256 threads an H100 SM holds: 2,048 threads,
    228 KB of shared memory with 1 KB reserved a block."""
    return min(2048 // G.THREADS, 233_472 // (smem_bytes + 1024))


GATHER_1D_SHAPES = sorted({(c.dims["C"], c.dims["N"]) for c in PG.script_cases()
                           if c.probe in ("take", "taa")} | {(8192, 131073), (8191, 1001), (8192, 5)})


@pytest.mark.parametrize("smem", [False, True])
@pytest.mark.parametrize("C,N", GATHER_1D_SHAPES)
def test_gather_1d_plan_covers_every_lookup_once(C, N, smem):
    """For every probe shape and ragged ones, at each 4-byte offset of the
    indices and the table: the plan's scalar head and tail and its blocks'
    runs of 16-byte vectors (as csrc/gather.cu's gather_1d_kernel walks
    them) cover every index once, the vectors start on a 16-byte
    boundary, the staged table and its mbarrier fit shared memory with
    the table's first bulk entry on a 16-byte boundary, and the blocks
    fill the SMs at most once."""
    if smem and C * 4 + 16 > H100_SMEM:
        return
    for off in range(4):
        idx_addr = table_addr = 4096 + 4 * off
        per_sm = _h100_blocks_per_sm(G.gather_1d_smem_bytes(C, table_addr) if smem else 0)
        plan = G.gather_1d_plan(N, C, smem, idx_addr, table_addr, H100_SMS, per_sm)
        count = np.zeros(N, dtype=np.int64)
        count[: plan.head] += 1
        count[plan.head + 4 * plan.vectors:] += 1
        for b in range(plan.blocks):
            lo, hi = b * plan.per_block, min((b + 1) * plan.per_block, plan.vectors)
            assert lo < hi or plan.vectors == 0  # no block without work
            count[plan.head + 4 * lo: plan.head + 4 * hi] += 1
        assert (count == 1).all()
        assert N - plan.head - 4 * plan.vectors < 4 and plan.head < 4
        assert plan.vectors == 0 or (idx_addr + 4 * plan.head) % 16 == 0
        assert 1 <= plan.blocks <= H100_SMS * per_sm
        # the head and tail need 6 threads; a warp multiple
        assert plan.threads % 32 == 0 and 6 <= plan.threads <= 1024
        if smem:
            assert (table_addr + 4 * plan.lead) % 16 == 0
            assert (plan.stage_at + plan.lead) % 4 == 0 and plan.stage_at < 4
            # the table, then the mbarrier on the next 16-byte boundary
            assert plan.bar_at % 4 == 0 and 0 <= plan.bar_at - (plan.stage_at + C) < 4
            assert 4 * plan.bar_at + G.BAR_BYTES == plan.smem_bytes <= H100_SMEM
            # every block gathers at least C indices, or there is one per SM
            assert plan.blocks <= max(-(-N // C), H100_SMS)
        else:
            assert plan.lead == 0 and plan.smem_bytes == 0


COLS_SHAPES = [(C, 128, 8192) for C in (512, 2048, 8192)] + [
    (6144, 128, 8192), (14000, 128, 8192), (14400, 128, 8192), (16384, 128, 8192), (512, 100, 4099),
    (2048, 6, 1000), (3, 128, 17), (8192, 128, 1),
    (G.SLAB_MAX_ROWS, 128, 8192), (G.SLAB_MAX_ROWS + 1, 128, 8192), (4096, 300, 33)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("C,K,M", COLS_SHAPES)
def test_gather_cols_plan_covers_every_lookup_once(C, K, M, aligned):
    """For the probe's shapes and ragged ones (14,000 table rows, width
    100, 131,073-style odd row counts): the blocks' rectangles of index
    rows x slab columns cover every lookup once, each slab and its
    mbarrier fit 232,448 bytes of shared memory, the slab holds every
    table row in whole TMA boxes of at most 256 rows, and the L2 route is
    taken exactly where the slab route does not run: tensors off a
    16-byte boundary, a width no multiple of 4, or a table past
    ``SLAB_MAX_ROWS`` rows, the measured crossover.  On the L2 route the
    blocks stride over every index row and the threads over every
    column."""
    plan = G.gather_cols_plan(C, K, M, aligned, H100_SMS, H100_SMEM)
    padded = -(-C // G.BOX_ROWS) * G.BOX_ROWS
    # up to the crossover the narrowest slab always fits the H100
    assert -(-G.SLAB_MAX_ROWS // G.BOX_ROWS) * G.BOX_ROWS * 4 * min(G.TMA_WIDTHS) + G.BAR_BYTES \
        <= H100_SMEM
    assert (plan.k > 0) == (aligned and K % 4 == 0 and C <= G.SLAB_MAX_ROWS)
    if plan.k == 0:
        assert plan == G.l2_route(K, M)
        assert plan.slabs == 1 and plan.smem_bytes == 0 and plan.boxes == 0
        assert 1 <= plan.row_splits <= min(max(M, 1), G.L2_MAX_BLOCKS)
        assert plan.threads % 32 == 0 and 32 <= plan.threads <= G.L2_THREADS
        rows = np.zeros(M, dtype=np.int64)
        for x in range(plan.row_splits):
            rows[x::plan.row_splits] += 1
        cols = np.zeros(K, dtype=np.int64)
        for t in range(plan.threads):
            cols[t::plan.threads] += 1
        assert (rows == 1).all() and (cols == 1).all()
        return
    assert plan.k % 4 == 0 and (plan.k in G.TMA_WIDTHS or plan.k == K)
    assert plan.smem_bytes <= H100_SMEM
    count = np.zeros((M, K), dtype=np.int64)
    for x in range(plan.row_splits):
        for s in range(plan.slabs):
            count[x * plan.rows_per: (x + 1) * plan.rows_per, s * plan.k: (s + 1) * plan.k] += 1
    assert (count == 1).all()
    assert (plan.row_splits - 1) * plan.rows_per < M
    assert plan.box_rows <= 256 and plan.boxes * plan.box_rows >= C > (plan.boxes - 1) * plan.box_rows
    assert padded == plan.boxes * plan.box_rows
    # each box lands 128-byte aligned; the slab, then the mbarrier
    assert plan.box_rows * plan.k * 4 % 128 == 0
    assert plan.smem_bytes == plan.boxes * plan.box_rows * plan.k * 4 + G.BAR_BYTES
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    # about one block per SM
    assert plan.slabs * plan.row_splits <= max(H100_SMS, plan.slabs)


def test_slab_plan_takes_the_widest_slab_that_fits():
    """Below the crossover the widest of 32, 16 and 8 columns whose padded
    table fits; none where not even 8 columns fit (the L2 route then)."""
    assert G.slab_plan(512, 128, 8192, H100_SMS, H100_SMEM).k == 32
    assert G.slab_plan(2048, 128, 8192, H100_SMS, H100_SMEM).k == 16
    assert G.slab_plan(G.SLAB_MAX_ROWS, 128, 8192, H100_SMS, H100_SMEM).k == 8
    assert G.slab_plan(G.SLAB_MAX_ROWS, 128, 8192, H100_SMS, 64 * 1024) is None
    assert G.gather_cols_plan(G.SLAB_MAX_ROWS, 128, 8192, True, H100_SMS, 64 * 1024) == \
        G.l2_route(128, 8192)


ROWS_SHAPES = sorted({(c.dims["W"], c.dims["L"]) for c in PG.script_cases() + PG.edge_cases()
                      if c.probe == "rows"} | {(63, 5), (17, 33), (1, 1), (3, 3), (1001, 7)})


@pytest.mark.parametrize("W,L", ROWS_SHAPES)
def test_gather_rows_plan_covers_every_lookup_once(W, L):
    """For every probe shape of ``gather_rows`` and ragged ones (rows of
    5, 7 and 33 indices, odd row counts), at each 4-byte offset of the
    indices, checked by intervals (the probe's shapes reach 2^25
    lookups): the scalar head and tail and the blocks' runs of 16-byte
    vectors cover the W * L flat lookups once, the vectors start on a
    16-byte boundary, each block is one pass of its threads (of 1, 2 or
    4 vectors a thread), its warps' slices fit a block's shared memory
    without opting in (48 KB), and the row divider is the multiply-high
    division and gives i // L at the first and last lookups and around
    the row boundaries it samples."""
    n = W * L
    for off, row_vectors in itertools.product(range(4), (1, 2, 4)):
        idx_addr = 4096 + 4 * off
        plan = G.gather_rows_plan(W, L, idx_addr, row_vectors)
        assert plan.head < 4 and 0 <= n - plan.head - 4 * plan.vectors < 4
        assert plan.vectors == 0 or (idx_addr + 4 * plan.head) % 16 == 0
        assert plan.per_block == plan.threads * row_vectors
        hi = 0
        for b in range(plan.blocks):
            lo, hi_b = b * plan.per_block, min((b + 1) * plan.per_block, plan.vectors)
            assert lo == hi and (lo < hi_b or plan.vectors == 0)
            hi = hi_b
        assert hi == plan.vectors
        # the head and tail need 6 threads; a warp multiple
        assert plan.threads % 32 == 0 and 6 <= plan.threads <= 1024
        assert plan.smem_bytes == plan.threads // 32 * row_vectors * 128 * 4 <= 48 * 1024
        row = plan.row
        assert row.L == L and 0 < row.magic < 1 << 32
        probes = {0, n - 1, plan.head, plan.head + 4 * plan.vectors - 1}
        probes |= {w * L + d for w in np.linspace(0, W - 1, 64).astype(int) for d in (-1, 0, 1)}
        for i in sorted(p for p in probes if 0 <= p < n):
            assert row(i) == i // L


@pytest.mark.parametrize("L", [1, 3, 5, 7, 32, 33, 100, 1000, 12345, 1 << 30, (1 << 31) - 1])
def test_multiply_high_division_is_exact_below_2_31(L):
    """The multiply-high row division equals i // L for dividends up to
    2^31 - 1, and its sum before the shift stays inside 32 bits; where L
    is a power of two it is a plain shift (magic 1)."""
    div = G.row_divider(L, 1 << 31)
    magic = div.magic
    assert (magic == 1) == (L & (L - 1) == 0)
    rng = np.random.default_rng(L)
    edge = [0, 1, L - 1, L, L + 1, (1 << 31) - 1, (1 << 31) - 2]
    edge += [q * L + d for q in (1, 2, ((1 << 31) - 1) // L) for d in (-1, 0, 1)]
    for i in edge + [int(x) for x in rng.integers(0, 1 << 31, 2000)]:
        if 0 <= i < 1 << 31:
            assert div(i) == i // L
            assert ((i * magic) >> 32) + i < 1 << 32


def test_row_divider_past_2_31_divides_in_64_bits():
    """Past 2^31 lookups every row length takes the 64-bit division."""
    big = (1 << 31) + 5
    assert G.row_divider(5, big) == G.RowDivider(5, 0, 0)
    assert G.row_divider(5, big)(big - 1) == (big - 1) // 5
    assert G.row_divider(32, big) == G.RowDivider(32, 0, 0)
    assert G.row_divider(32, big)(big - 1) == (big - 1) // 32
    assert G.row_divider(5, 1 << 31).magic > 0
    with pytest.raises(ValueError, match="2\\^31"):
        G.row_divider(5, 100)(1 << 31)


@pytest.mark.parametrize("W,L,C2", [(63, 5, 512), (17, 33, 128), (65, 32, 256), (5, 1, 32)])
def test_gather_rows_kernel_arithmetic_matches_numpy(W, L, C2):
    """The kernel's walk and arithmetic on the CPU: the head and tail one
    by one, then each warp's runs of 32 vectors transposed as
    gather_vectors transposes them (lane l makes lookups 32c + l of a run
    of 128), ``out[i] = R[row(i) * C2 + idx[i]]``: equal to numpy's
    take_along_axis at every 4-byte offset of the indices, with 1 or 2
    vectors a thread."""
    rng = np.random.default_rng(W * L)
    R = rng.integers(0, 1 << 16, (W, C2)).astype(np.int32)
    idx = rng.integers(0, C2, (W, L)).astype(np.int32)
    want = np.take_along_axis(R, idx, axis=1).reshape(-1)
    flat_r, flat_i = R.reshape(-1), idx.reshape(-1)
    for off, row_vectors in itertools.product(range(4), (1, 2)):
        plan = G.gather_rows_plan(W, L, 4096 + 4 * off, row_vectors)
        got = np.full(W * L, -1, dtype=np.int64)

        def look(i):
            assert got[i] == -1  # once
            got[i] = flat_r[plan.row(i) * C2 + flat_i[i]]

        for i in list(range(plan.head)) + list(range(plan.head + 4 * plan.vectors, W * L)):
            look(i)
        warps = plan.threads // 32
        for b in range(plan.blocks):
            v0, v1 = b * plan.per_block, min((b + 1) * plan.per_block, plan.vectors)
            for w in range(warps):
                for vb in range(v0 + 32 * w, v1, row_vectors * plan.threads):
                    for u in range(row_vectors):
                        base = vb + u * plan.threads  # the run's first vector
                        for c in range(4):
                            for lane in range(32):
                                e = 32 * c + lane
                                if base + e // 4 < v1:
                                    look(plan.head + 4 * base + e)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("off", range(4))
def test_output_takes_the_index_alignment(off):
    """gather_1d's output starts at the indices' address mod 16, so one
    peel aligns both; a view of the right shape and dtype."""
    base = torch.zeros(1000 + 4, dtype=torch.int32)
    idx = base[off: off + 1000].view(10, 100)
    out = G._same_alignment(idx, idx.device)
    assert out.data_ptr() % 16 == idx.data_ptr() % 16
    assert out.shape == idx.shape and out.dtype == torch.int32 and out.is_contiguous()


def test_kernel_source_stands_alone():
    """gather.cu includes no local header: its digest is its own bytes."""
    files = B.kernel_files(os.path.join(B.CSRC, "gather.cu"))
    assert [os.path.basename(f) for f in files] == ["gather.cu"]


def test_script_cases_cover_every_shape_of_the_scripts():
    cases = PG.script_cases()
    shapes = {}
    for c in cases:
        shapes.setdefault(c.probe, set()).add(tuple(sorted(c.dims.items())))
    take = {(("C", C), ("N", N)) for C in (8192, 262144) for N in (8192, 131072)}
    assert take <= shapes["take"]
    assert (("C", 8192), ("N", 131072)) in shapes["taa"]
    assert shapes["two_level"] == {
        (("C", C), ("N", N)) for C in (8192, 262144, 1 << 21) for N in (8192, 131072)
    }
    kernel_rows = {(("C2", C2), ("L", 32), ("W", 1 << 17)) for C2 in (128, 256, 512)}
    xla_rows = {(("C2", C2), ("L", 32), ("W", 1 << 20)) for C2 in (32, 128, 256, 512)}
    assert shapes["rows"] == kernel_rows | xla_rows
    assert shapes["cols"] == {(("C", C), ("N", 1 << 20)) for C in (512, 2048, 8192)}
    small_c = {(("C", C), ("N", 1 << 22)) for C in (256, 1024, 8192)}
    assert small_c <= shapes["take"] and small_c <= shapes["taa"]
    assert set(PG.KERNELS) == set(shapes)


def test_probe_runs_on_cpu_without_times():
    """The probe's loop at tiny shapes on the CPU (where every entry point
    runs its twin): the checks run, no time is printed."""
    cases = [
        PG.Case("take", "t", dict(C=512, N=256)),
        PG.Case("taa", "t", dict(C=512, N=256)),
        PG.Case("two_level", "t", dict(C=2048, N=512)),
        PG.Case("rows", "t", dict(W=16, C2=128, L=32)),
        PG.Case("cols", "t", dict(C=64, N=256)),
    ]
    out = io.StringIO()
    rows = PG.run("cpu", cases=cases, label="cpu", out=out)
    assert [r["probe"] for r in rows] == ["take", "taa", "two_level", "rows", "cols"]
    assert all(r["max_abs_err"] == 0 and "ms" not in r for r in rows)
    assert rows[2]["matches_composed"] and not rows[2]["matches_true_gather"]
    assert rows[3]["lookups"] == 16 * 32
    text = out.getvalue()
    assert text.count("times not measured") == 5 and " ms" not in text


@pytest.mark.parametrize("probe,dims,wrong", [
    # reads column 0 whatever the lane
    ("cols", dict(C=64, N=256), lambda t, i: t[:, 0][i.long()]),
    # forgets the row's offset
    ("rows", dict(W=16, C2=128, L=32), lambda R, i: R.reshape(-1)[i.long()]),
    # the true gather, which the composed gather is not
    ("two_level", dict(C=2048, N=512), lambda t, i: t.reshape(-1)[i.long()]),
])
def test_probe_inputs_tell_a_wrong_kernel_from_the_twin(probe, dims, wrong):
    """The probe holds each kernel against its twin on the card on
    ``make_inputs``' tensors; a plausible wrong kernel must give another
    answer on them, or the check could not see it."""
    gen = torch.Generator()
    gen.manual_seed(PG.SEED)
    args = PG.make_inputs(PG.Case(probe, "t", dims), gen, "cpu")
    _kernel, twin = PG.kernel_and_twin(probe)
    assert not torch.equal(wrong(*args), twin(*args))


@pytest.mark.parametrize("probe,dims", [
    ("take", dict(C=512, N=256)),
    ("taa", dict(C=512, N=256)),
    ("two_level", dict(C=2048, N=512)),
    ("rows", dict(W=16, C2=128, L=32)),
    ("cols", dict(C=64, N=256)),
])
def test_library_call_and_bound_of_each_probe(probe, dims):
    """The yardstick call computes the twin's function (none for the
    two-level gather's composed semantics), and the bound counts each
    index and output once and each table entry the indices reach once."""
    gen = torch.Generator()
    gen.manual_seed(PG.SEED)
    args = PG.make_inputs(PG.Case(probe, "t", dims), gen, "cpu")
    _kernel, twin = PG.kernel_and_twin(probe)
    lib = PG.library_call(probe, args)
    if probe == "two_level":
        assert lib is None
    else:
        assert torch.equal(lib(), twin(*args))
    table, idx = args
    nbytes = PG.bound_bytes(probe, args)
    assert 8 * idx.numel() < nbytes <= 4 * (table.numel() + 2 * idx.numel())
    if probe in ("take", "taa"):
        assert nbytes == 4 * (int(torch.unique(idx).numel()) + 2 * idx.numel())
    # whole 32-byte sectors: never fewer bytes than the entries, at most a
    # sector a lookup or the whole table
    sectors = PG.sector_bytes(probe, args)
    assert nbytes <= sectors <= 8 * idx.numel() + 32 * min(idx.numel(), table.numel() // 8 + 1)
    if probe in ("take", "taa"):
        addr = (table.data_ptr() + 4 * idx.to(torch.int64)) // 32
        assert sectors == 32 * int(torch.unique(addr).numel()) + 8 * idx.numel()


def test_sector_bound_counts_sectors_by_address():
    """A table view whose entries straddle sectors: 8 lookups of
    neighbouring entries reach one sector when the table starts on a
    sector, two when it starts 4 bytes before one."""
    base = torch.zeros(64, dtype=torch.int32)
    start = (-base.data_ptr() % 32) // 4  # first entry on a 32-byte boundary
    idx = torch.arange(8, dtype=torch.int32)
    on = base[start: start + 40]
    off = base[start + 7: start + 47]
    assert PG.sector_bytes("take", (on, idx)) == 32 + 64
    assert PG.sector_bytes("take", (off, idx)) == 64 + 64
    assert PG.bound_bytes("take", (on, idx)) == PG.bound_bytes("take", (off, idx)) == 4 * 8 + 64


def test_empty_launch_is_timed_by_the_same_timer(monkeypatch):
    slept = []
    monkeypatch.setattr(torch.cuda, "_sleep", slept.append)
    assert PG.empty_launch_ms(timer=lambda fn, cold=False: (fn(), 0.0021)[1]) == 0.0021
    assert slept == [0]


def test_edge_cases_reach_each_kernels_edges():
    """The edge shapes hold what the kernels' designs turn on: rows of 5
    and 33 indices, an odd row count and index views at an offset for
    gather_rows; 2^22 indices into a 2^21 table, into a table past the
    L2 cache and an offset view for gather_two_level; tables at the
    crossover and one row past it for gather_cols."""
    edges = PG.edge_cases()
    rows = [c.dims for c in edges if c.probe == "rows"]
    assert {d["L"] for d in rows} >= {5, 33}
    assert any(d["W"] % 2 for d in rows) and any(d.get("off") for d in rows)
    two = [c.dims for c in edges if c.probe == "two_level"]
    assert dict(C=1 << 21, N=1 << 22) in two and any(d.get("off") for d in two)
    assert any(4 * d["C"] > 50 << 20 for d in two)  # the H100's L2 holds 50 MB
    cols = {d["C"] for d in (c.dims for c in edges if c.probe == "cols") if "K" not in d}
    assert {G.SLAB_MAX_ROWS, G.SLAB_MAX_ROWS + 1} <= cols
    assert all(not c.pallas and c.origin == "edge" for c in edges)


def test_probe_times_carry_bound_and_library_call():
    out = io.StringIO()
    rows = PG.run("cpu", cases=[PG.Case("take", "t", dict(C=512, N=256)),
                                PG.Case("two_level", "t", dict(C=2048, N=512))],
                  timer=lambda fn, cold=False: (fn(), 2.0 if cold else 1.0)[1], out=out)
    assert rows[0]["library_ms"] == 1.0 and rows[1]["library_ms"] is None
    assert all(r["ms"] == 1.0 and r["cold_ms"] == 2.0 for r in rows)
    assert all(0 < r["bound_ms"] <= r["sector_bound_ms"] < 1e-3 for r in rows)
    assert f"sector bound {rows[1]['sector_bound_ms']:.4f} ms" in out.getvalue()
    # the share is read from the cold time
    assert f"share {rows[0]['bound_ms'] / 2.0:.3f} (of the cold time)" in out.getvalue()


class _FakeCuda:
    """A stream whose clock moves by the sleep's cycles and the calls'
    device time, and a host clock that moves by each call's enqueue."""

    def __init__(self, ms_per_cycle, host_ms_per_call, dev_ms_per_call):
        self.dev = self.host = 0.0
        self.sleeps = []
        self.flushes = 0
        self.ms_per_cycle = ms_per_cycle
        self.host_ms, self.dev_ms = host_ms_per_call, dev_ms_per_call
        fake = self

        class Event:
            def __init__(self, enable_timing=False):
                self.t = None

            def record(self):
                self.t = fake.dev

            def elapsed_time(self, other):
                return other.t - self.t

        self.Event = Event

    def synchronize(self):
        pass

    def _sleep(self, cycles):
        self.sleeps.append(cycles)
        self.dev += cycles * self.ms_per_cycle

    def perf_counter(self):
        return self.host / 1e3

    def call(self):
        self.host += self.host_ms
        self.dev += self.dev_ms

    def flush(self):
        self.flushes += 1
        self.dev += 0.5


@pytest.mark.parametrize("host_ms,sleeps", [
    (0.01, 1),  # the first lead outlasts the enqueue
    (0.3, 3),  # it takes two doublings
    (50.0, None),  # no lead outlasts it: the time would be the host's
])
def test_cuda_time_times_the_device_or_raises(monkeypatch, host_ms, sleeps):
    first_lead_ms = 2.0
    fake = _FakeCuda(first_lead_ms / SC.LEAD_CYCLES, host_ms, dev_ms_per_call=0.003)
    for name in ("Event", "synchronize", "_sleep"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(SC.time, "perf_counter", fake.perf_counter)
    # the enqueue of REPS calls against leads of 2, 4, 8, ... ms
    if sleeps is None:
        with pytest.raises(RuntimeError, match="host-paced"):
            SC.cuda_time(fake.call)
        assert len(fake.sleeps) == SC.LEAD_DOUBLINGS + 1
    else:
        assert SC.cuda_time(fake.call) == pytest.approx(0.003)
        assert fake.sleeps == [SC.LEAD_CYCLES << k for k in range(sleeps)]


def test_cold_cuda_time_flushes_before_each_call_and_times_only_the_call(monkeypatch):
    """Under ``cold`` every call follows an L2 flush, and the flush's
    device time stays out of the call's time."""
    fake = _FakeCuda(2.0 / SC.LEAD_CYCLES, 0.01, dev_ms_per_call=0.003)
    for name in ("Event", "synchronize", "_sleep"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(SC.time, "perf_counter", fake.perf_counter)
    monkeypatch.setattr(SC, "_l2_flush", lambda: fake.flush)
    assert SC.cuda_time(fake.call, cold=True) == pytest.approx(0.003)
    assert fake.flushes == SC.REPS
    assert SC.cuda_time(fake.call) == pytest.approx(0.003) and fake.flushes == SC.REPS


def test_probe_main_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PG.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


def _gather_ab():
    sys.path.insert(0, os.path.join(os.path.dirname(B.CSRC), os.pardir, "tools"))
    try:
        import gather_ab
    finally:
        sys.path.pop(0)
    return gather_ab


def test_ab_tool_loads_another_checkout_and_compares_on_cpu():
    """tools/gather_ab.py imports another checkout's ops.gather under its
    own name (here this checkout's), holds both entry points to the twin
    at each case and prints each round's ratio and repeat ratios, in the
    order other, this, this, other."""
    ab = _gather_ab()
    other = ab.load_gather(os.path.join(os.path.dirname(B.CSRC), os.pardir), name="ab_test_ops")
    assert other is not G and other.__name__ == "ab_test_ops.gather"
    assert other.build is not G.build
    cases = [PG.Case("take", "t", dict(C=512, N=256)), PG.Case("two_level", "t", dict(C=2048, N=512)),
             PG.Case("rows", "t", dict(W=16, C2=128, L=5, off=1))]
    seen = []

    def timer(fn, cold=False):
        seen.append(cold)
        return 1.0 if cold else 2.0

    out = io.StringIO()
    rows = ab.compare(other, cases, timer, rounds=2, device="cpu", label="cpu", out=out)
    assert [(r["probe"], r["round"]) for r in rows] == [
        (p, k) for p in ("take", "two_level", "rows") for k in (1, 2)]
    assert all(r["ratio_ms"] == r["ratio_cold_ms"] == 1.0 for r in rows)
    assert all(r["repeat_ms"] == (1.0, 1.0) for r in rows)
    assert seen == ([False] * 4 + [True] * 4) * 6
    assert out.getvalue().count("round 2: other 2.0000 / this 2.0000 ms = 1.000") == 3


def test_ab_tool_refuses_a_wrong_kernel(monkeypatch):
    ab = _gather_ab()
    monkeypatch.setattr(ab, "entry", lambda mod, probe: (
        (lambda R, i: R.reshape(-1)[i.long()]) if mod is not G else G.gather_rows))
    with pytest.raises(RuntimeError, match="other differs from the twin"):
        ab.compare(object(), [PG.Case("rows", "t", dict(W=16, C2=128, L=32))],
                   lambda fn, cold=False: 1.0, device="cpu", out=io.StringIO())


def test_ab_tool_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert _gather_ab().main(["--crossover"]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# each probe at a scripts' shape, then the edge shapes: ragged N, views at
# a 4-byte offset, a table length no multiple of 4, gather_two_level on
# 2^22 indices and an offset view, gather_rows on rows of 5 and 33 indices,
# odd row counts and offset views, gather_cols at the crossover (the last
# slab) and one row past it, 6,144, 14,000 and 16,384 (the L2 route),
# width 100 and an offset index view (the L2 route)
CUDA_CASES = [
    ("take", dict(C=262144, N=131072)), ("taa", dict(C=8192, N=131072)),
    ("two_level", dict(C=1 << 21, N=131072)), ("rows", dict(W=1 << 12, C2=512, L=32)),
    ("cols", dict(C=8192, N=1 << 16)),
    ("take", dict(C=8192, N=131073)), ("taa", dict(C=8192, N=131073)),
    ("take", dict(C=8192, N=4099, off=1)), ("taa", dict(C=8192, N=4099, off=1)),
    ("taa", dict(C=8191, N=1001, off=3)), ("taa", dict(C=8192, N=5, off=2)),
    ("two_level", dict(C=1 << 21, N=1 << 22)), ("two_level", dict(C=8192, N=128 * 33, off=1)),
    ("rows", dict(W=4099, C2=512, L=5)), ("rows", dict(W=1025, C2=128, L=33, off=1)),
    ("rows", dict(W=4097, C2=256, L=32, off=3)), ("rows", dict(W=3, C2=32, L=1, off=2)),
    ("cols", dict(C=512, N=1 << 16)), ("cols", dict(C=2048, N=1 << 16)),
    ("cols", dict(C=G.SLAB_MAX_ROWS, N=1 << 16)), ("cols", dict(C=G.SLAB_MAX_ROWS + 1, N=1 << 16)),
    ("cols", dict(C=6144, N=1 << 16)),
    ("cols", dict(C=14000, N=1 << 16)), ("cols", dict(C=16384, N=1 << 16)),
    ("cols", dict(C=512, K=100, N=100 * 4099)), ("cols", dict(C=2048, N=1 << 16, off=1)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("probe,dims", CUDA_CASES,
                         ids=[f"{p}-" + "-".join(f"{k}{v}" for k, v in d.items()) for p, d in CUDA_CASES])
def test_kernel_matches_twin_on_cuda(probe, dims):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    G.reset_launches()
    row = PG.run_case(PG.Case(probe, "test", dims), "cuda", gen)
    torch.cuda.synchronize()
    assert row["max_abs_err"] == 0
    kernel, mode, _replaces = PG.KERNELS[probe]
    launches = G.gather_1d.launches_by_mode[mode] if mode else getattr(G, kernel).launches
    assert launches == 1
    if probe == "cols":
        aligned = dims.get("K", G.LANES) % 4 == 0 and not dims.get("off")
        assert row["route"] == ("slab" if aligned and dims["C"] <= G.SLAB_MAX_ROWS else "l2")


@pytest.mark.cuda
def test_smem_mode_refuses_a_table_that_does_not_fit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    table = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")  # 256 KB
    idx = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        G.gather_1d(table, idx, smem=True)
