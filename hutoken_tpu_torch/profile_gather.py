"""Gather-rate probe on one CUDA device: the three TPU gather-profiling
scripts (``scripts/profile_pallas_gather.py``,
``scripts/profile_pallas_gather2.py``, ``scripts/profile_gather3.py``)
with their loops, shapes and checks, run through the hand-written
kernels of ``ops/gather.py`` and their plain PyTorch twins.

    python -m hutoken_tpu_torch.profile_gather

For each shape it checks kernel == twin exactly (and, for the two-level
gather, the script's composed semantics and whether it happens to equal
a true gather) and prints both times with CUDA events and both rates in
M lookups/s.  The scripts' XLA-only sections (``profile_gather3.py``
sections 1 and 2) become rows whose plain time is the point; the kernel
of the same function runs beside them.  Inputs are drawn on the device
from a seeded generator.  Without a CUDA device it exits with an error:
a CPU run measures nothing.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import torch

from .ops import gather as G

REPS = 20  # timed calls per kernel and shape
SEED = 0
LEAD_CYCLES = 1 << 25  # first length of the sleep that leads each timed loop
LEAD_DOUBLINGS = 4  # times the sleep may double before the timer gives up


@dataclass(frozen=True)
class Case:
    """One probe shape.  ``probe`` is ``take`` / ``taa`` (gather_1d
    through L2 / shared memory), ``two_level``, ``rows`` or ``cols``;
    ``origin`` the script line whose loop it ports; ``pallas`` False for
    the shapes of the scripts' XLA-only sections."""

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


def make_inputs(case: Case, gen: torch.Generator, device) -> tuple:
    """The script's tensors for one case (int32, drawn on ``device``)."""
    d = case.dims

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=gen, device=device, dtype=torch.int32)

    if case.probe in ("take", "taa"):
        return ints(1 << 20, (d["C"],)), ints(d["C"], (d["N"] // G.LANES, G.LANES))
    if case.probe == "two_level":
        return (ints(1 << 20, (d["C"] // G.LANES, G.LANES)),
                ints(d["C"], (d["N"] // G.LANES, G.LANES)))
    if case.probe == "rows":
        return ints(1 << 16, (d["W"], d["C2"])), ints(d["C2"], (d["W"], d["L"]))
    # cols: the script broadcasts a [C, 1] table, whose equal columns would
    # hide a kernel that reads the wrong column; the same layout, every
    # entry drawn
    return ints(1 << 16, (d["C"], G.LANES)), ints(d["C"], (d["N"] // G.LANES, G.LANES))


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


def cuda_time(fn) -> float:
    """Device ms per call of ``fn`` over ``REPS`` back-to-back calls, by
    CUDA events, after one warm call.

    A call at the scripts' smaller shapes runs for a few microseconds on
    the card, less than the host takes to enqueue it, so events around a
    plain loop would time the host.  A sleep kernel queued first holds
    the stream while the host enqueues every call; the sleep is doubled
    until it outlasts the enqueue, and the timer raises if it never does
    rather than return a time the host paced."""
    fn()
    torch.cuda.synchronize()
    for doubling in range(LEAD_DOUBLINGS + 1):
        lead, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        lead.record()
        torch.cuda._sleep(LEAD_CYCLES << doubling)
        start.record()
        t0 = time.perf_counter()
        for _ in range(REPS):
            fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lead_ms = lead.elapsed_time(start)
        if lead_ms > enqueue_ms:
            return start.elapsed_time(end) / REPS
    raise RuntimeError(
        f"cuda_time: a {lead_ms:.3f} ms lead did not outlast the host's "
        f"{enqueue_ms:.3f} ms enqueue of {REPS} calls; the loop was host-paced"
    )


def run_case(case: Case, device, gen: torch.Generator,
             timer: Optional[Callable] = None) -> dict:
    """Check one case and (with a timer) time kernel and twin.  Raises
    if the kernel differs from its twin or the composed semantics."""
    args = make_inputs(case, gen, device)
    kernel, twin = kernel_and_twin(case.probe)
    got, want = kernel(*args), twin(*args)
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    row = {"probe": case.probe, "case": case.name, "origin": case.origin,
           "pallas": case.pallas, "lookups": case.lookups, "max_abs_err": err}
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
        row["plain_ms"] = timer(lambda: twin(*args))
    return row


def run(device, cases: Optional[list[Case]] = None, timer: Optional[Callable] = None,
        label: str = "", out=sys.stdout) -> list[dict]:
    """Every case on ``device``; one line each.  Times and rates only
    with a timer (on the card, :func:`cuda_time`); a CPU run prints "not
    measured"."""
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    rows = []
    for case in cases if cases is not None else script_cases():
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
            times = (f"kernel {row['ms']:.4f} ms ({n / row['ms'] / 1e3:.0f} M/s), "
                     f"twin {row['plain_ms']:.4f} ms ({n / row['plain_ms'] / 1e3:.0f} M/s)")
        prefix = f"[{label}] " if label else ""
        print(f"{prefix}gather probe {what:18s} {case.name:24s} ({case.origin}): "
              f"kernel == twin (max_abs_err {row['max_abs_err']}, tolerance 0);{extra} {times}",
              file=out, flush=True)
    return rows


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


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
    run("cuda", timer=cuda_time, label=label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
