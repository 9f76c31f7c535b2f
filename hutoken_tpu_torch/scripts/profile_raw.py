"""The raw cache-cold path against the word pipeline on the high-entropy
corpus, with the raw path's host stages timed one by one (counterpart of
``scripts/profile_raw.py`` and ``scripts/profile_raw_stages.py``).

    python -m hutoken_tpu_torch.scripts.profile_raw [--mb 8] [--mode raw|pipeline|both] [--runs 2]
    python -m hutoken_tpu_torch.scripts.profile_raw --device cpu --mb 1

Each mode (``HUTOKEN_TPU_RAW=1`` or ``=0``) builds the 768-id fixture's
engine, runs ``warmup()`` and one checked run (three documents against
the oracle), then ``--runs`` cold runs of ``encode_batch_arrays``
(``reset_cache()`` first, the window closed by
``torch.cuda.synchronize()``): MB/s, the device byte share, the host
bytes by cause and the kernels' launches.

A raw run also prints its host stages, from the engine's
``stat_raw_seconds`` (host clock, summed over the run's threads):

* ``producer``: the producer thread's busy time (UTF-8 encode, chunk
  assembly), of which ``find_cut`` (the safe cut of a document longer
  than the room left, ``ops/split.py::find_cut``) and ``alphabet``
  (``supported_alphabet``);
* ``main_wait``: the main thread waiting for the producer's next chunk;
* ``launch``: upload and chunk program per chunk, of which
  ``nonzero_sync``, the wait at the chunk's one host sync
  (``torch.nonzero`` in ``ops/split.py::chunk_words``);
* ``copy_wait`` and ``splice``: the drainers waiting for the copies
  back and encoding words over 32 bytes on the host
  (``RawChunkEncoder.finish``);
* ``assembly``: per-document counts and the final concatenation.

The windowed 96/128-byte program of ``profile_raw_stages.py`` was left
out of the port by design (``ops/split.py``), so these stages are the
port's own.
"""

from __future__ import annotations

import argparse
import os
import sys

from ..corpora import build_unique_corpus
from .common import add_device_arg, launch_counts, load_ctx, open_device, wall

STAGES = ("producer", "find_cut", "alphabet", "main_wait", "launch", "nonzero_sync",
          "copy_wait", "splice", "assembly")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mb", type=float, default=8.0)
    ap.add_argument("--mode", default="both", choices=("raw", "pipeline", "both"))
    ap.add_argument("--runs", type=int, default=2)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    label = open_device(args.device)

    from .. import oracle
    from ..engine import TorchTokenizer

    docs = build_unique_corpus(args.mb)
    total = sum(len(d.encode()) for d in docs)
    print(f"corpus: {total / 1e6:.2f} MB, {len(docs)} docs", flush=True)
    ctx = load_ctx("small")
    old = os.environ.get("HUTOKEN_TPU_RAW")
    try:
        for mode in (("raw", "pipeline") if args.mode == "both" else (args.mode,)):
            os.environ["HUTOKEN_TPU_RAW"] = "1" if mode == "raw" else "0"
            eng = TorchTokenizer(ctx, device=args.device)
            eng.warmup()
            (flat, offs), dt = wall(lambda: eng.encode_batch_arrays(docs), args.device)
            for i in (0, len(docs) // 2, len(docs) - 1):
                if flat[offs[i]: offs[i + 1]].tolist() != oracle.encode(ctx, docs[i]):
                    raise RuntimeError(f"[{mode}] document {i} differs from the oracle")
            print(f"[{label}] [{mode}] first run {dt:.3f} s; 3 documents equal to the oracle", flush=True)
            for r in range(args.runs):
                eng.reset_cache()
                d0, c0, l0 = eng.stat_device_bytes, dict(eng.stat_host_cause), launch_counts()
                s0 = dict(eng.stat_raw_seconds)
                _out, dt = wall(lambda: eng.encode_batch_arrays(docs), args.device)
                cause = {k: v - c0.get(k, 0) for k, v in eng.stat_host_cause.items() if v - c0.get(k, 0)}
                launches = {k: v - l0[k] for k, v in launch_counts().items() if v - l0[k]}
                print(f"[{label}] [{mode}] run {r}: {dt:.3f} s = {total / dt / 1e6:.2f} MB/s "
                      f"device_byte_share={(eng.stat_device_bytes - d0) / total:.4f} "
                      f"cause={cause} launches={launches}", flush=True)
                if mode == "raw":
                    secs = {k: eng.stat_raw_seconds.get(k, 0.0) - s0.get(k, 0.0) for k in STAGES}
                    print(f"[{label}] [raw] run {r} host stages (s, summed over threads; wall "
                          f"{dt:.3f}): " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items()), flush=True)
    finally:
        if old is None:
            os.environ.pop("HUTOKEN_TPU_RAW", None)
        else:
            os.environ["HUTOKEN_TPU_RAW"] = old
    return 0


if __name__ == "__main__":
    sys.exit(main())
