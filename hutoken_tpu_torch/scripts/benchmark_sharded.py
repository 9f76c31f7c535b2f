"""Weak scaling of sharded encode on the port's data mesh (counterpart of
``scripts/benchmark_sharded.py``): constant work per shard over
``data_mesh(1)``, ``data_mesh(2)``, ``data_mesh(4)``, ...

    python -m hutoken_tpu_torch.scripts.benchmark_sharded [--shards 1,2,4] [--rows 16384]
    python -m hutoken_tpu_torch.scripts.benchmark_sharded --device cpu --rows 256 --mb 0.1

Two workloads at each mesh size n, both on the 768-id fixture:

* ``sharded_merge_words`` on a ``[rows * n, lanes]`` block of random
  byte ids (numpy, seed 0): words/s over ``--iters`` calls, the window
  closed by ``torch.cuda.synchronize()``;
* the mesh engine, ``TorchTokenizer(ctx, mesh=data_mesh(n))``, on
  ``--mb * n`` MB of the high-entropy corpus: a cold ``encode_batch``
  (``reset_cache()`` first, after ``warmup()``), MB/s and the blocks each
  shard sent to the fused kernel.

Every output is checked against one shard (``data_mesh(1)``) on the same
input; a difference raises.  The scaling efficiency is the rate at n over
n times the rate at 1 (at the smallest size given, scaled).

Several shards on one card, or on the CPU (``--device cpu``), share that
device: as ``scripts/benchmark_sharded.py`` says of ``--cpu``, this shows
the program's mechanics (exact outputs at every mesh size, a launch per
shard), not scaling, which needs a card per shard.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from ..corpora import build_unique_corpus
from .common import add_device_arg, load_ctx, open_device, sync, wall


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shards", default="1,2,4", help="mesh sizes, comma-separated")
    ap.add_argument("--rows", type=int, default=16384, help="block rows per shard")
    ap.add_argument("--lanes", type=int, default=32)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--mb", type=float, default=2.0, help="corpus MB per shard for the engine")
    ap.add_argument("--json", default=None, help="also write the results here")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    label = open_device(args.device)

    import torch

    from ..engine import TorchTokenizer
    from ..parallel.mesh import data_mesh
    from ..parallel.sharded import sharded_merge_words
    from ..tables import build_encoder_tables, device_tables

    ctx = load_ctx("small")
    tab = device_tables(build_encoder_tables(ctx), ctx, args.device)
    one = data_mesh(1, args.device)
    single = TorchTokenizer(ctx, mesh=one)
    single.warmup()
    rng = np.random.RandomState(0)
    merge_rates, engine_rates, rows_out = {}, {}, []
    for n in (int(x) for x in args.shards.split(",")):
        mesh = data_mesh(n, args.device)

        rows = args.rows * n
        block = rng.randint(0, 256, size=(rows, args.lanes)).astype(np.int32)
        want = torch.cat([o.cpu() for o in sharded_merge_words(tab, one, block)])
        got = torch.cat([o.cpu() for o in sharded_merge_words(tab, mesh, block)])
        if not torch.equal(got, want):
            raise RuntimeError(f"sharded_merge_words on {n} shards differs from one shard")
        sync(args.device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            sharded_merge_words(tab, mesh, block)
        sync(args.device)
        merge_rates[n] = rows * args.iters / (time.perf_counter() - t0)

        docs = build_unique_corpus(args.mb * n, seed=n)
        nbytes = sum(len(d.encode()) for d in docs)
        engine = TorchTokenizer(ctx, mesh=mesh)
        engine.warmup()
        single.reset_cache()
        want_docs = single.encode_batch(docs)
        engine.reset_cache()
        fused0 = list(engine.stat_shard_fused)
        got_docs, dt = wall(lambda: engine.encode_batch(docs), args.device)
        if got_docs != want_docs:
            raise RuntimeError(f"the mesh engine on {n} shards differs from one shard")
        engine_rates[n] = nbytes / dt / 1e6
        per_shard = [b - a for a, b in zip(fused0, engine.stat_shard_fused)]
        base = min(merge_rates)  # the smallest mesh run, normally 1 shard
        row = {
            "shards": n,
            "merge_words_per_s": merge_rates[n],
            "merge_efficiency": merge_rates[n] * base / (merge_rates[base] * n),
            "engine_mb_per_s": engine_rates[n],
            "engine_efficiency": engine_rates[n] * base / (engine_rates[base] * n),
            "engine_mb": nbytes / 1e6,
            "fused_blocks_per_shard": per_shard,
        }
        rows_out.append(row)
        print(f"[{label}] {n} shard(s): sharded_merge_words {rows} x {args.lanes} "
              f"{merge_rates[n] / 1e6:.3f} M words/s (efficiency {row['merge_efficiency']:.3f}); "
              f"mesh engine {nbytes / 1e6:.2f} MB cold {engine_rates[n]:.2f} MB/s "
              f"(efficiency {row['engine_efficiency']:.3f}), fused blocks per shard {per_shard}; "
              f"equal to one shard", flush=True)
    result = {
        "metric": "sharded encode weak scaling by mesh size",
        "device": label,
        "devices": len(set(mesh.devices)),
        "rows_per_shard": args.rows,
        "engine_mb_per_shard": args.mb,
        "runs": rows_out,
        "note": "shards sharing one device show the mechanics, not scaling",
    }
    print(json.dumps(result), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
