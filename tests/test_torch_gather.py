"""The gather kernels (hutoken_tpu_torch/ops/gather.py) and the probe
that runs them (hutoken_tpu_torch/profile_gather.py): each plain PyTorch
twin against the Pallas kernel it replaces, built as its script builds it
but in interpret mode, and against the script's own numpy oracle; the
CUDA kernels against their twins on the card.  Values are integers: every
comparison is exact.

The kernel bodies are closures inside each script's ``main()``, so they
are restated here with their file and line."""

import io
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import tpu as pltpu  # noqa: E402

from hutoken_tpu_torch import profile_gather as PG  # noqa: E402
from hutoken_tpu_torch.ops import build as B  # noqa: E402
from hutoken_tpu_torch.ops import gather as G  # noqa: E402

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
    (2048, 6, 1000), (3, 128, 17), (8192, 128, 1)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("C,K,M", COLS_SHAPES)
def test_gather_cols_plan_covers_every_lookup_once(C, K, M, aligned):
    """For the probe's shapes and ragged ones (14,000 table rows, width
    100, 131,073-style odd row counts): the blocks' rectangles of index
    rows x slab columns cover every lookup once, each slab and its
    mbarrier fit 232,448 bytes of shared memory, the slab holds every
    table row in whole TMA boxes of at most 256 rows, clusters tile the
    grid, and the L2 route is taken exactly where the slab cannot take
    the input: tensors off a 16-byte boundary, a width no multiple of 4,
    or no 4-column slab that fits."""
    plan = G.gather_cols_plan(C, K, M, aligned, H100_SMS, H100_SMEM)
    padded = -(-C // G.BOX_ROWS) * G.BOX_ROWS
    assert (plan.k > 0) == (aligned and K % 4 == 0
                            and padded * 4 * 4 + G.BAR_BYTES <= H100_SMEM)
    if plan.k == 0:
        assert plan == G.L2_ROUTE
        return
    assert plan.k % 4 == 0 and plan.smem_bytes <= H100_SMEM
    count = np.zeros((M, K), dtype=np.int64)
    for x in range(plan.row_splits):
        for s in range(plan.slabs):
            count[x * plan.rows_per: (x + 1) * plan.rows_per, s * plan.k: (s + 1) * plan.k] += 1
    assert (count == 1).all()
    assert (plan.row_splits - 1) * plan.rows_per < M or plan.cluster > 1
    assert plan.box_rows <= 256 and plan.boxes * plan.box_rows >= C > (plan.boxes - 1) * plan.box_rows
    # each box lands 128-byte aligned; the slab, then the mbarrier
    assert plan.box_rows * plan.k * 4 % 128 == 0
    assert plan.smem_bytes == plan.boxes * plan.box_rows * plan.k * 4 + G.BAR_BYTES
    assert plan.cluster in (1, 2) and plan.row_splits % plan.cluster == 0
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    # about one block per SM
    assert plan.slabs * plan.row_splits <= max(H100_SMS, plan.slabs * plan.cluster)


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


def test_probe_times_carry_bound_and_library_call():
    out = io.StringIO()
    rows = PG.run("cpu", cases=[PG.Case("take", "t", dict(C=512, N=256)),
                                PG.Case("two_level", "t", dict(C=2048, N=512))],
                  timer=lambda fn, cold=False: (fn(), 2.0 if cold else 1.0)[1], out=out)
    assert rows[0]["library_ms"] == 1.0 and rows[1]["library_ms"] is None
    assert all(r["ms"] == 1.0 and r["cold_ms"] == 2.0 for r in rows)
    assert all(0 < r["bound_ms"] < 1e-3 for r in rows)
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
    fake = _FakeCuda(first_lead_ms / PG.LEAD_CYCLES, host_ms, dev_ms_per_call=0.003)
    for name in ("Event", "synchronize", "_sleep"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(PG.time, "perf_counter", fake.perf_counter)
    # the enqueue of REPS calls against leads of 2, 4, 8, ... ms
    if sleeps is None:
        with pytest.raises(RuntimeError, match="host-paced"):
            PG.cuda_time(fake.call)
        assert len(fake.sleeps) == PG.LEAD_DOUBLINGS + 1
    else:
        assert PG.cuda_time(fake.call) == pytest.approx(0.003)
        assert fake.sleeps == [PG.LEAD_CYCLES << k for k in range(sleeps)]


def test_cold_cuda_time_flushes_before_each_call_and_times_only_the_call(monkeypatch):
    """Under ``cold`` every call follows an L2 flush, and the flush's
    device time stays out of the call's time."""
    fake = _FakeCuda(2.0 / PG.LEAD_CYCLES, 0.01, dev_ms_per_call=0.003)
    for name in ("Event", "synchronize", "_sleep"):
        monkeypatch.setattr(torch.cuda, name, getattr(fake, name))
    monkeypatch.setattr(PG.time, "perf_counter", fake.perf_counter)
    monkeypatch.setattr(PG, "_l2_flush", lambda: fake.flush)
    assert PG.cuda_time(fake.call, cold=True) == pytest.approx(0.003)
    assert fake.flushes == PG.REPS
    assert PG.cuda_time(fake.call) == pytest.approx(0.003) and fake.flushes == PG.REPS


def test_probe_main_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PG.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


# each probe at a scripts' shape, then the edge shapes: ragged N, views at
# a 4-byte offset, a table length no multiple of 4, gather_cols on 6,144
# table rows (an 8-column slab), 14,000 (a 4-column slab), 16,384 (the L2
# route), width 100 and an offset index view (the L2 route)
CUDA_CASES = [
    ("take", dict(C=262144, N=131072)), ("taa", dict(C=8192, N=131072)),
    ("two_level", dict(C=1 << 21, N=131072)), ("rows", dict(W=1 << 12, C2=512, L=32)),
    ("cols", dict(C=8192, N=1 << 16)),
    ("take", dict(C=8192, N=131073)), ("taa", dict(C=8192, N=131073)),
    ("take", dict(C=8192, N=4099, off=1)), ("taa", dict(C=8192, N=4099, off=1)),
    ("taa", dict(C=8191, N=1001, off=3)), ("taa", dict(C=8192, N=5, off=2)),
    ("cols", dict(C=512, N=1 << 16)), ("cols", dict(C=2048, N=1 << 16)),
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


@pytest.mark.cuda
def test_smem_mode_refuses_a_table_that_does_not_fit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    table = torch.zeros(1 << 16, dtype=torch.int32, device="cuda")  # 256 KB
    idx = torch.zeros((1, 128), dtype=torch.int32, device="cuda")
    with pytest.raises(ValueError, match="does not fit"):
        G.gather_1d(table, idx, smem=True)
