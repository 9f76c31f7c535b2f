"""A/B of the port's gather kernels against another checkout's, in one
process on one CUDA device.

    git archive <commit> hutoken_tpu_torch | tar -x -C build/other
    python tools/gather_ab.py build/other [--probes rows,two_level] [--rounds 3]
    python tools/gather_ab.py --crossover [--rounds 3]

The other checkout's ``hutoken_tpu_torch/ops`` is imported under another
name and builds its kernels into its own ``_build/``.  Both are called
through their entry points (``gather_1d``, ``gather_two_level``,
``gather_rows``), so any two checkouts that have them compare.  At
every script and edge shape of this checkout's ``profile_gather`` whose
probe is asked for, both outputs are held equal to the twin; then each
round times the two in the order other, this, this, other, back to back
and under a cold L2 (``scripts/common.py::cuda_time``), and prints
other / this beside the ratio of the round's two readings of each side,
the spread of the timer itself.

``--crossover`` times ``gather_cols``' two routes on this checkout at
tables around ``SLAB_MAX_ROWS`` (slab, L2, L2, slab in each round),
forcing the route by setting ``SLAB_MAX_ROWS`` to the table's row count
(slab) or one less (L2), beside one ``torch.gather``.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import sys
from typing import Callable, Optional

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from hutoken_tpu_torch.ops import gather as G  # noqa: E402
from hutoken_tpu_torch.scripts import profile_gather as PG  # noqa: E402
from hutoken_tpu_torch.scripts.common import card_label, cuda_time  # noqa: E402

CROSSOVER_ROWS = (4096, 4608, 5120, 5632, 6144, 6656, 7168)  # gather_cols tables, N = 2^20


def load_gather(tree: str, name: str = "other_ops"):
    """``hutoken_tpu_torch/ops/gather.py`` of the checkout rooted at
    ``tree``, imported as ``<name>.gather``."""
    path = os.path.join(os.path.abspath(tree), "hutoken_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.gather")


def entry(mod, probe: str) -> Callable:
    """The entry point of ``mod`` (an ``ops.gather``) for a probe."""
    if probe in ("take", "taa"):
        return lambda t, i: mod.gather_1d(t, i, smem=probe == "taa")
    return getattr(mod, PG.KERNELS[probe][0])


def rounds_of(calls: dict, order: list, timer: Callable, rounds: int) -> list[dict]:
    """Each round's readings of each call, in ``order``: ``{(name,
    cold): [ms, ...]}``, warm first, then under a cold L2."""
    result = []
    for _ in range(rounds):
        got: dict = {}
        for cold in (False, True):
            for name in order:
                got.setdefault((name, cold), []).append(timer(calls[name], cold=cold))
        result.append(got)
    return result


def _summary(got: dict, a: str, b: str) -> tuple[dict, str]:
    """Mean times, a / b and each side's repeat ratio, warm and cold."""
    row, parts = {}, []
    for cold, key in ((False, "ms"), (True, "cold_ms")):
        ta, tb = got[(a, cold)], got[(b, cold)]
        row[f"{a}_{key}"], row[f"{b}_{key}"] = sum(ta) / len(ta), sum(tb) / len(tb)
        row[f"ratio_{key}"] = row[f"{a}_{key}"] / row[f"{b}_{key}"]
        row[f"repeat_{key}"] = (ta[0] / ta[-1], tb[0] / tb[-1])
        parts.append(f"{'cold ' if cold else ''}{a} {row[f'{a}_{key}']:.4f} / {b} "
                     f"{row[f'{b}_{key}']:.4f} ms = {row[f'ratio_{key}']:.3f} (repeats "
                     f"{row[f'repeat_{key}'][0]:.3f}, {row[f'repeat_{key}'][1]:.3f})")
    return row, "; ".join(parts)


def compare(other, cases: list, timer: Callable, rounds: int = 3, device="cuda",
            label: str = "", out=sys.stdout) -> list[dict]:
    """``other``'s entry points (an ``ops.gather`` module) against this
    checkout's at each case; one line per case and round."""
    gen = torch.Generator(device=device)
    gen.manual_seed(PG.SEED)
    rows = []
    prefix = f"[{label}] " if label else ""
    for case in cases:
        args = PG.make_inputs(case, gen, device)
        fns = {"other": entry(other, case.probe), "this": entry(G, case.probe)}
        want = PG.kernel_and_twin(case.probe)[1](*args)
        for name, fn in fns.items():
            if not torch.equal(fn(*args), want):
                raise RuntimeError(f"{case.probe} {case.name}: {name} differs from the twin")
        calls = {name: (lambda fn=fn: fn(*args)) for name, fn in fns.items()}
        for k, got in enumerate(rounds_of(calls, ["other", "this", "this", "other"], timer, rounds)):
            row, text = _summary(got, "other", "this")
            rows.append({"probe": case.probe, "case": case.name, "round": k + 1, **row})
            print(f"{prefix}A/B {case.probe:9s} {case.name:28s} round {k + 1}: {text}",
                  file=out, flush=True)
    return rows


def crossover(timer: Callable, table_rows=CROSSOVER_ROWS, rounds: int = 3, label: str = "",
              out=sys.stdout) -> list[dict]:
    """``gather_cols``' slab route against its L2 route on ``[C, 128]``
    tables of each of ``table_rows`` rows and 2^20 indices.  Needs CUDA."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(PG.SEED)
    limit = G.SLAB_MAX_ROWS
    rows = []
    prefix = f"[{label}] " if label else ""
    try:
        for C in table_rows:
            tbl, idx = PG.make_inputs(PG.Case("cols", "crossover", dict(C=C, N=1 << 20)), gen, "cuda")

            def on(route, C=C, tbl=tbl, idx=idx):
                def call():
                    G.SLAB_MAX_ROWS = C if route == "slab" else C - 1
                    return G.gather_cols(tbl, idx)
                return call

            calls = {"slab": on("slab"), "l2": on("l2")}
            want = G.gather_cols_plain(tbl, idx)
            for route, call in calls.items():
                before = G.gather_cols.launches_by_route[route]
                if not torch.equal(call(), want) or G.gather_cols.launches_by_route[route] != before + 1:
                    raise RuntimeError(f"gather_cols C={C}: the {route} route did not give the twin")
            idx64 = idx.to(torch.int64)
            library_ms = timer(lambda: torch.gather(tbl, 0, idx64))
            for k, got in enumerate(rounds_of(calls, ["slab", "l2", "l2", "slab"], timer, rounds)):
                row, text = _summary(got, "slab", "l2")
                rows.append({"C": C, "round": k + 1, "library_ms": library_ms, **row})
                print(f"{prefix}gather_cols crossover C={C} round {k + 1}: {text}; "
                      f"torch.gather {library_ms:.4f} ms", file=out, flush=True)
    finally:
        G.SLAB_MAX_ROWS = limit
    return rows


def main(argv: Optional[list[str]] = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("other", nargs="?", help="root of the other checkout")
    parser.add_argument("--probes", default="take,taa,two_level,rows",
                        help="probes to compare (profile_gather.KERNELS)")
    parser.add_argument("--rounds", type=int, default=3)
    parser.add_argument("--crossover", action="store_true",
                        help="time gather_cols' two routes around SLAB_MAX_ROWS")
    opts = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gather_ab: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    label = card_label()
    print(label)
    if opts.other:
        other = load_gather(opts.other)
        other.build()
        G.build()
        probes = opts.probes.split(",")
        cases = [c for c in PG.script_cases() + PG.edge_cases() if c.probe in probes]
        compare(other, cases, cuda_time, opts.rounds, label=label)
    if opts.crossover:
        crossover(cuda_time, rounds=opts.rounds, label=label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
