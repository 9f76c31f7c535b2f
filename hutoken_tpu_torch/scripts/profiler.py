"""Profiling driver of the port (counterpart of ``scripts/profiler.py``):
a loop of cold ``encode_batch`` runs over ``--mb`` MB of the Zipf
corpus on the 768-id fixture, under ``torch.profiler`` or on the wall
clock.

    python -m hutoken_tpu_torch.scripts.profiler [--mb 4] [--iters 3] [--trace DIR]
    python -m hutoken_tpu_torch.scripts.profiler --device cpu --mb 0.25

With ``--trace DIR`` the ``--iters`` runs go under ``torch.profiler``
(CPU and CUDA activities), the Chrome trace is written to
``DIR/trace.json`` (open it in Perfetto or ``chrome://tracing``), and the
driver prints the top device operations by self time and the device's
busy share (device self time over the window's wall); a window in which
the tracer recorded no CUDA activity on the card is an error (exit 1),
never a share of 0.  Without it, or after it, each run prints its MB/s
on the wall clock, the window closed by ``torch.cuda.synchronize()``,
and on the card the last line gives the encode kernels' launch counts
in this process (``launches {...}``).  Every run starts with
``reset_cache()``, after one ``warmup()``.  On the CPU no device time
exists: the driver says so.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..corpora import build_corpus
from .common import add_device_arg, launch_counts, load_ctx, open_device, sync, top_device_ops


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=4.0)
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--trace", default=None, help="directory for a torch.profiler Chrome trace")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    label = open_device(args.device)

    from ..engine import TorchTokenizer

    eng = TorchTokenizer(load_ctx("small"), device=args.device)
    docs = build_corpus(args.mb)
    total = sum(len(d.encode()) for d in docs)
    eng.warmup()
    eng.encode_batch(docs[:8])

    def loop() -> float:
        sync(args.device)
        t0 = time.perf_counter()
        for _ in range(args.iters):
            eng.reset_cache()
            eng.encode_batch(docs)
        sync(args.device)
        return time.perf_counter() - t0

    if args.trace:
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if args.device == "cuda" else [])
        with profile(activities=acts) as prof:
            secs = loop()
        os.makedirs(args.trace, exist_ok=True)
        path = os.path.join(args.trace, "trace.json")
        prof.export_chrome_trace(path)
        print(f"trace of {args.iters} runs written to {path}", flush=True)
        busy, top = top_device_ops(prof) if args.device == "cuda" else (0.0, [])
        if busy > 0:
            print(f"[{label}] {args.iters} runs of {total / 1e6:.2f} MB: wall {secs:.3f} s under the "
                  f"profiler, device self time {busy * 1e3:.3f} ms, busy share {busy / secs:.4f}", flush=True)
            for name, s, calls in top:
                print(f"  {s * 1e3:10.3f} ms {calls:6d} calls  {name[:80]}", flush=True)
        elif args.device == "cuda":
            # no CUDA activity is no measurement of zero
            print(f"[{label}] torch.profiler traced no CUDA activity in this window", file=sys.stderr)
            return 1
        else:
            print("device time: not measured (the CPU runs the plain twins)", flush=True)
    for i in range(args.iters):
        eng.reset_cache()
        sync(args.device)
        t0 = time.perf_counter()
        eng.encode_batch(docs)
        sync(args.device)
        dt = time.perf_counter() - t0
        print(f"[{label}] iter {i}: {total / dt / 1e6:.2f} MB/s ({dt:.3f} s, {total / 1e6:.2f} MB)", flush=True)
    if args.device == "cuda":
        print(f"launches {json.dumps(launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
