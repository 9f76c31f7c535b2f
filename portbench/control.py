"""The control of the check: the configuration's plain reference,
computed with every pair rank kept to 8 fewer bits (``rank_shift=8``),
put in the program's place at a cell's own size, and judged by the same
check.  It has to come out as not correct.

    python3 -m portbench.control --workload <name> --seeds 11,12,13

prints, per seed, the numbers compared (one JSON line each).  The
window is as short as the check allows: the kept calls' worth.  The
benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from . import check, registry
from .harness import CHECK_SEED, reference, vocab_files
from .pool import make_pool, seed_of
from .window import run_window

RANK_SHIFT = 8


def control_run(config: dict, config_path: str, traffic: dict, seed: int,
                cache: str | None = None) -> dict:
    """One control run; returns the check's result and its seconds."""
    files = vocab_files(config, config_path, cache)
    pool = make_pool(traffic, seed)
    low = reference(config, files, rank_shift=RANK_SHIFT)

    def encode(batch):
        return [low.encode(d) for d in batch]

    calls = int(traffic["check_calls"])
    t = time.perf_counter()
    w = run_window(encode, pool.batches, pool.call_bytes, 0.0, sample=calls - 2,
                   seed=seed_of(seed), min_calls=calls)
    window_s = time.perf_counter() - t
    ref = reference(config, files)
    docs = int(traffic["check_docs"])
    out = check.compare(w.kept, pool.batches, ref, docs, docs * calls, seed_of(seed) ^ CHECK_SEED)
    out["window_s"] = window_s
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    bench = registry.load_benchmark()
    cell = registry.cell(bench, args.workload)
    config, config_path = registry.config(bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    for s in args.seeds.split(","):
        r = control_run(config, config_path, traffic, int(s))
        print(json.dumps({"workload": cell["name"], "seed": int(s), "correct": r["correct"],
                          "window_s": r["window_s"], "check": r["numbers"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
