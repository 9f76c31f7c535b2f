"""Gather-rate probe on one CUDA device: the three TPU gather-profiling
scripts (``scripts/profile_pallas_gather.py``,
``scripts/profile_pallas_gather2.py``, ``scripts/profile_gather3.py``)
with their loops, shapes and checks, run through the hand-written
kernels of ``ops/gather.py`` and their plain PyTorch twins.

    python -m hutoken_tpu_torch.scripts.profile_gather

For each shape, and for the edge shapes of :func:`edge_cases` (ragged
counts, views at an offset, tables on either side of ``gather_cols``'
crossover), it checks kernel == twin exactly (and, for the two-level
gather, the script's composed semantics and whether it happens to equal
a true gather) and prints both times with CUDA events and both rates in
M lookups/s, beside the shape's bound (the bytes it must move at the
card's memory rate), its sector bound (the same with the table read in
whole 32-byte sectors) and the time of one PyTorch call computing the
same function on indices prepared beforehand, a yardstick only.  Calls
run back to back, so a shape whose bytes fit the L2 cache may run faster
than its bound; the kernel is also timed with L2 flushed before each
call, and its share of the bound is taken from that cold time.  An
empty launch's time prints first: no call can take less.  The scripts'
XLA-only sections (``profile_gather3.py`` sections 1 and 2) become rows
whose plain time is the point; the kernel of the same function runs
beside them.  Inputs are drawn on the device from a seeded generator.
Without a CUDA device it exits with an error: a CPU run measures
nothing.
"""

from __future__ import annotations

import argparse
import math
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from ..ops import gather as G
from .common import card_label, cuda_time

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
SEED = 0


@dataclass(frozen=True)
class Case:
    """One probe shape.  ``probe`` is ``take`` / ``taa`` (gather_1d
    through L2 / shared memory), ``two_level``, ``rows`` or ``cols``;
    ``origin`` the script line whose loop it ports ("edge" for
    :func:`edge_cases`); ``pallas`` False for the shapes of the scripts'
    XLA-only sections and the edge shapes."""

    probe: str
    origin: str
    dims: dict = field(default_factory=dict)
    pallas: bool = True

    @property
    def lookups(self) -> int:
        d = self.dims
        return d["W"] * d["L"] if self.probe == "rows" else d["N"]

    @property
    def name(self) -> str:
        return " ".join(f"{k}={v}" for k, v in self.dims.items())


# (probe, kernel entry, TPU kernel it replaces)
KERNELS = {
    "take": ("gather_1d", "l2", "scripts/profile_pallas_gather.py:42"),
    "taa": ("gather_1d", "smem", "scripts/profile_pallas_gather.py:70"),
    "two_level": ("gather_two_level", None, "scripts/profile_pallas_gather2.py:64"),
    "rows": ("gather_rows", None, "scripts/profile_gather3.py:61"),
    "cols": ("gather_cols", None, "scripts/profile_gather3.py:98"),
}


def script_cases() -> list[Case]:
    """Every shape of the three scripts, in their order."""
    cases = [
        Case("take", "scripts/profile_pallas_gather.py:36", dict(C=C, N=N))
        for C in (8192, 262144) for N in (8192, 131072)
    ]
    cases.append(Case("taa", "scripts/profile_pallas_gather.py:64", dict(C=8192, N=131072)))
    cases += [
        Case("two_level", "scripts/profile_pallas_gather2.py:36", dict(C=C, N=N))
        for C in (8192, 262144, 2 << 20) for N in (8192, 131072)
    ]
    # profile_gather3.py section 1 (XLA take_along_axis row gather)
    cases += [
        Case("rows", "scripts/profile_gather3.py:35", dict(W=1 << 20, C2=C2, L=32), pallas=False)
        for C2 in (32, 128, 256, 512)
    ]
    # section 2 (XLA shared-table gather at small C), both table modes
    cases += [
        Case(probe, "scripts/profile_gather3.py:46", dict(C=C, N=1 << 22), pallas=False)
        for C in (256, 1024, 8192) for probe in ("take", "taa")
    ]
    # sections 3 and 3b (the Pallas kernels)
    cases += [
        Case("rows", "scripts/profile_gather3.py:55", dict(W=1 << 17, C2=C2, L=32))
        for C2 in (128, 256, 512)
    ]
    cases += [
        Case("cols", "scripts/profile_gather3.py:92", dict(C=C, N=1 << 20))
        for C in (512, 2048, 8192)
    ]
    return cases


def edge_cases() -> list[Case]:
    """Shapes no script has, for the kernels' edges: a count of indices
    that is no multiple of 4 or 128 (ragged N), a table and indices that
    are views at a 4-byte offset (``off``: they start ``off`` int32 into
    a larger tensor, so not on a 16-byte boundary), a table length that is
    no multiple of 4, ``gather_two_level`` on 2^22 indices into a 2^21
    table (launches no longer dominate) and into a 2^25 table (128 MB,
    past the L2 cache) and on an index view at an offset,
    ``gather_rows`` with rows of 5 and 33 indices (no power of two), an
    odd row count and index views at an offset, ``gather_cols`` with
    tables of 4,096 rows (an 8-column slab), ``SLAB_MAX_ROWS`` (the last
    table of the slab route) and one row more, 6,144 rows (where the two
    routes ran level), 14,000 and 16,384 rows (the L2 route), a width of
    100 (the last slab 4 columns wide) and an index view at an offset
    (the L2 route)."""
    edge = "edge"
    return [
        Case("take", edge, dict(C=8192, N=131073), pallas=False),
        Case("taa", edge, dict(C=8192, N=131073), pallas=False),
        Case("take", edge, dict(C=8192, N=131072, off=1), pallas=False),
        Case("taa", edge, dict(C=8192, N=131072, off=1), pallas=False),
        Case("taa", edge, dict(C=8191, N=1001, off=3), pallas=False),
        Case("two_level", edge, dict(C=1 << 21, N=1 << 22), pallas=False),
        Case("two_level", edge, dict(C=1 << 25, N=1 << 22), pallas=False),
        Case("two_level", edge, dict(C=8192, N=131072, off=1), pallas=False),
        Case("rows", edge, dict(W=(1 << 17) - 1, C2=512, L=5), pallas=False),
        Case("rows", edge, dict(W=(1 << 15) + 1, C2=128, L=33, off=1), pallas=False),
        Case("rows", edge, dict(W=(1 << 17) - 1, C2=512, L=32, off=3), pallas=False),
        Case("cols", edge, dict(C=4096, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=G.SLAB_MAX_ROWS, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=G.SLAB_MAX_ROWS + 1, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=6144, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=14000, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=16384, N=1 << 20), pallas=False),
        Case("cols", edge, dict(C=512, K=100, N=100 * 4099), pallas=False),
        Case("cols", edge, dict(C=2048, N=1 << 20, off=1), pallas=False),
    ]


def make_inputs(case: Case, gen: torch.Generator, device) -> tuple:
    """The script's tensors for one case (int32, drawn on ``device``).
    Indices come as ``[N / 128, 128]`` where N allows, else flat; with
    ``off`` in the dims the table and the indices are views that start
    ``off`` entries into larger tensors."""
    d = case.dims
    off = d.get("off", 0)

    def ints(hi, shape):
        flat = torch.randint(0, hi, (math.prod(shape) + off,), generator=gen, device=device,
                             dtype=torch.int32)
        return flat[off:].view(shape)

    if case.probe in ("take", "taa"):
        N = d["N"]
        shape = (N // G.LANES, G.LANES) if N % G.LANES == 0 else (N,)
        return ints(1 << 20, (d["C"],)), ints(d["C"], shape)
    if case.probe == "two_level":
        return (ints(1 << 20, (d["C"] // G.LANES, G.LANES)),
                ints(d["C"], (d["N"] // G.LANES, G.LANES)))
    if case.probe == "rows":
        return ints(1 << 16, (d["W"], d["C2"])), ints(d["C2"], (d["W"], d["L"]))
    # cols: the script broadcasts a [C, 1] table, whose equal columns would
    # hide a kernel that reads the wrong column; the same layout, every
    # entry drawn
    K = d.get("K", G.LANES)
    return ints(1 << 16, (d["C"], K)), ints(d["C"], (d["N"] // K, K))


def kernel_and_twin(probe: str) -> tuple[Callable, Callable]:
    if probe == "take":
        return (lambda t, i: G.gather_1d(t, i, smem=False)), G.gather_1d_plain
    if probe == "taa":
        return (lambda t, i: G.gather_1d(t, i, smem=True)), G.gather_1d_plain
    return {
        "two_level": (G.gather_two_level, G.gather_two_level_plain),
        "rows": (G.gather_rows, G.gather_rows_plain),
        "cols": (G.gather_cols, G.gather_cols_plain),
    }[probe]


def library_call(probe: str, args: tuple) -> Optional[Callable]:
    """One PyTorch call computing the probe's function, its indices
    widened to int64 beforehand; None for the two-level gather, whose
    composed semantics take two calls."""
    table, idx = args
    idx64 = idx.to(torch.int64)
    if probe in ("take", "taa"):
        return lambda: table[idx64]
    if probe == "rows":
        return lambda: torch.gather(table, 1, idx64)
    if probe == "cols":
        return lambda: torch.gather(table, 0, idx64)
    return None


def reached(probe: str, args: tuple) -> torch.Tensor:
    """The flat table entries a call's lookups read, one per lookup."""
    table, idx = args
    idx64 = idx.to(torch.int64)
    if probe in ("take", "taa"):
        return idx64.reshape(-1)
    if probe == "two_level":
        lanes = idx64 & (G.LANES - 1)
        return (torch.gather(idx64 >> 7, 1, lanes) * G.LANES + lanes).reshape(-1)
    if probe == "rows":
        rows = torch.arange(idx64.shape[0], device=idx.device)[:, None]
        return (rows * table.shape[1] + idx64).reshape(-1)
    # cols
    return (idx64 * table.shape[1] + torch.arange(idx64.shape[1], device=idx.device)).reshape(-1)


def bound_bytes(probe: str, args: tuple) -> int:
    """The bytes a call must move: every index read once, every output
    written once, and each table entry these indices reach read once."""
    entries = int(torch.unique(reached(probe, args)).numel())
    return 4 * (entries + 2 * args[1].numel())


def sector_bytes(probe: str, args: tuple) -> int:
    """The bytes a call must move where the table is read in whole 32-byte
    sectors, as device memory serves it: every index and output once, and
    each distinct sector (by address) that the lookups reach."""
    table, idx = args
    sectors = torch.unique((table.data_ptr() + 4 * reached(probe, args)) // 32)
    return 32 * int(sectors.numel()) + 8 * idx.numel()


def run_case(case: Case, device, gen: torch.Generator,
             timer: Optional[Callable] = None) -> dict:
    """Check one case and (with a timer) time kernel and twin, and the
    kernel again under a cold L2.  Raises if the kernel differs from its
    twin or the composed semantics."""
    args = make_inputs(case, gen, device)
    kernel, twin = kernel_and_twin(case.probe)
    routes = dict(G.gather_cols.launches_by_route)
    got, want = kernel(*args), twin(*args)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    row = {"probe": case.probe, "case": case.name, "origin": case.origin,
           "pallas": case.pallas, "lookups": case.lookups, "max_abs_err": err}
    if case.probe == "cols":
        # the route the first call took (None where no kernel ran)
        row["route"] = next((r for r, n in G.gather_cols.launches_by_route.items()
                             if n > routes[r]), None)
    if err != 0:
        raise RuntimeError(f"{case.probe} {case.name}: kernel differs from its twin by {err}")
    if case.probe == "two_level":
        # the script's own checks (profile_pallas_gather2.py:90-97)
        t2d, idx = args
        idx64 = idx.to(torch.int64)
        rows, lanes = idx64 >> 7, idx64 & (G.LANES - 1)
        composed = t2d[torch.gather(rows, 1, lanes), lanes]
        row["matches_composed"] = bool(torch.equal(got, composed))
        row["matches_true_gather"] = bool(torch.equal(got, t2d.reshape(-1)[idx64]))
        if not row["matches_composed"]:
            raise RuntimeError(f"two_level {case.name}: not the composed gather")
    if timer is not None:
        row["ms"] = timer(lambda: kernel(*args))
        row["cold_ms"] = timer(lambda: kernel(*args), cold=True)
        row["plain_ms"] = timer(lambda: twin(*args))
        lib = library_call(case.probe, args)
        row["library_ms"] = timer(lib) if lib is not None else None
        row["bound_ms"] = bound_bytes(case.probe, args) / HBM_BYTES_PER_S * 1e3
        row["sector_bound_ms"] = sector_bytes(case.probe, args) / HBM_BYTES_PER_S * 1e3
    return row


def run(device, cases: Optional[list[Case]] = None, timer: Optional[Callable] = None,
        label: str = "", out=sys.stdout) -> list[dict]:
    """Every case (by default the scripts' and the edge shapes) on
    ``device``; one line each.  Times and rates only with a timer (on the
    card, ``common.cuda_time``); a CPU run prints "not measured"."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []
    for case in cases if cases is not None else script_cases() + edge_cases():
        row = run_case(case, device, gen, timer)
        rows.append(row)
        kernel, mode, _replaces = KERNELS[case.probe]
        what = f"{kernel}[{mode}]" if mode else kernel
        extra = ""
        if case.probe == "two_level":
            extra = (f" matches-composed={row['matches_composed']}"
                     f" matches-true-gather={row['matches_true_gather']};")
        if timer is None:
            times = "times not measured"
        else:
            n = case.lookups
            lib = row["library_ms"]
            times = (f"kernel {row['ms']:.4f} ms ({n / row['ms'] / 1e3:.0f} M/s), "
                     f"twin {row['plain_ms']:.4f} ms ({n / row['plain_ms'] / 1e3:.0f} M/s), "
                     f"one PyTorch call {'%.4f ms' % lib if lib is not None else 'none'}, "
                     f"kernel under a cold L2 {row['cold_ms']:.4f} ms, "
                     f"bound {row['bound_ms']:.4f} ms (bytes), "
                     f"sector bound {row['sector_bound_ms']:.4f} ms, "
                     f"share {row['bound_ms'] / row['cold_ms']:.3f} (of the cold time)")
        if row.get("route"):
            extra += f" route {row['route']};"
        prefix = f"[{label}] " if label else ""
        print(f"{prefix}gather probe {what:18s} {case.name:24s} ({case.origin}): "
              f"kernel == twin (max_abs_err {row['max_abs_err']}, tolerance 0);{extra} {times}",
              file=out, flush=True)
    return rows


def empty_launch_ms(timer: Callable = None) -> float:
    """The time of an empty launch (``torch.cuda._sleep(0)``) by the same
    timer: the floor under every time of the probe."""
    return (timer or cuda_time)(lambda: torch.cuda._sleep(0))


def main(argv: Optional[list[str]] = None) -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_gather: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    label = card_label()
    print(label)
    t0 = time.perf_counter()
    G.build()
    print(f"gather kernels built in {time.perf_counter() - t0:.1f} s")
    print(f"[{label}] empty launch (torch.cuda._sleep(0)) {empty_launch_ms():.4f} ms")
    run("cuda", timer=cuda_time, label=label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
