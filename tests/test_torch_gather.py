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


class _FakeCuda:
    """A stream whose clock moves by the sleep's cycles and the calls'
    device time, and a host clock that moves by each call's enqueue."""

    def __init__(self, ms_per_cycle, host_ms_per_call, dev_ms_per_call):
        self.dev = self.host = 0.0
        self.sleeps = []
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


def test_probe_main_needs_cuda(capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert PG.main([]) == 1
    assert "no CUDA device" in capsys.readouterr().err


@pytest.mark.cuda
@pytest.mark.parametrize("probe", sorted(PG.KERNELS))
def test_kernel_matches_twin_on_cuda(probe):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    dims = {"take": dict(C=262144, N=131072), "taa": dict(C=8192, N=131072),
            "two_level": dict(C=1 << 21, N=131072), "rows": dict(W=1 << 12, C2=512, L=32),
            "cols": dict(C=8192, N=1 << 16)}[probe]
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
