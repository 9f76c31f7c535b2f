#!/usr/bin/env python3
"""Where the device string trainer's time goes, on one CUDA card.

    python3 tools/string_train_profile.py [--mb 4] [--merges 5000] [--budget 400] [--seed 0]

Trains ``scripts/benchmark_train.py``'s text (``--mb`` MB, seed
``--seed``) to ``256 + --merges`` with ``parallel.train.distributed_bpe_train``
on ``data_mesh()``, under ``cProfile``, and prints: a progress line every
100 merges (merges, seconds, live ids), the calls and seconds of the
exact host pick (``_host_exact_string_pick``), the scan chunks and deep
steps (``chip_smoke.StringTrace``), ``STRING_SCAN_STATS``, and the host
functions that took the most time.  The run stops at the first progress
line past ``--budget`` seconds.  Prints the card's name and power limit
first; exits 1 without CUDA.
"""

from __future__ import annotations

import argparse
import cProfile
import os
import pstats
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)


class Budget(Exception):
    """The run passed its time budget."""


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("string_train_profile: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--mb", type=float, default=4.0)
    ap.add_argument("--merges", type=int, default=5000)
    ap.add_argument("--budget", type=float, default=400.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import chip_smoke as CS
    from hutoken_tpu_torch.parallel import data_mesh
    from hutoken_tpu_torch.parallel import train as PT
    from hutoken_tpu_torch.scripts.common import card_label
    from hutoken_tpu_torch.train import common

    print(card_label(), flush=True)
    data = CS.train_corpus(args.mb, args.seed)
    mesh = data_mesh()
    exact = {"calls": 0, "s": 0.0}
    pick = PT._host_exact_string_pick

    def timed_pick(ids_np, csid2spell):
        t = time.perf_counter()
        try:
            return pick(ids_np, csid2spell)
        finally:
            exact["calls"] += 1
            exact["s"] += time.perf_counter() - t

    t0 = time.perf_counter()
    state = {"merges": 0}
    save = common.save_checkpoint

    def progress(str2id, path):
        state["merges"] += 100
        secs = time.perf_counter() - t0
        print(f"{state['merges']} merges at {secs:.1f} s; exact host picks {exact['calls']} "
              f"({exact['s']:.1f} s); stats {PT.STRING_SCAN_STATS}", flush=True)
        if secs > args.budget:
            raise Budget

    PT._host_exact_string_pick = timed_pick
    common.save_checkpoint = progress
    prof = cProfile.Profile()
    with tempfile.TemporaryDirectory() as tmp, CS.StringTrace() as tr:
        prof.enable()
        try:
            PT.distributed_bpe_train(data, 256 + args.merges, mesh=mesh, verbose=False,
                                     checkpoint_path=os.path.join(tmp, "v.txt"), checkpoint_every=100)
        except Budget:
            print(f"stopped at the budget of {args.budget} s")
        finally:
            prof.disable()
            torch.cuda.synchronize()
            common.save_checkpoint = save
            PT._host_exact_string_pick = pick
    secs = time.perf_counter() - t0
    print(f"{len(data)} B: {secs:.1f} s, {tr.chunks} chunks, {tr.deep} deep steps, exact host picks "
          f"{exact['calls']} ({exact['s']:.1f} s), stats {PT.STRING_SCAN_STATS}")
    pstats.Stats(prof).sort_stats("tottime").print_stats(25)
    return 0


if __name__ == "__main__":
    sys.exit(main())
