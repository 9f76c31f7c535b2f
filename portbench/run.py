"""Run one cell of the benchmark once.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object: ``correct``, ``attempted`` (calls), ``failed`` (calls that
raised), ``metrics`` (the cell's end-to-end metrics, or with ``--trace
1`` its per-layer ones), ``device`` and, with ``--trace 1``,
``breakdown``; ``check``, the numbers compared beside their limits,
comes last.  The same numbers end standard error.

The run exits non-zero and prints no result: without a CUDA device or
with fewer than the cell asks for; when ``BENCHMARK.json`` or the
program is missing; when a ``HUTOKEN_TPU_*`` variable would steer the
program off the path users run; when the native host library does not
load; when the engine takes another table than the configuration
states; when a traced window sees no device event; and
when JAX or the JAX package was loaded in this process.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "hutoken_tpu")


def forbidden_modules(names) -> list[str]:
    """Top-level names among ``names`` (module names) that are JAX's or
    the JAX package's, compared whole: ``hutoken_tpu_torch`` is not
    ``hutoken_tpu``."""
    return sorted({n.split(".", 1)[0] for n in names} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="portbench.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def fail(msg: str) -> int:
    print(f"portbench: {msg}", file=sys.stderr, flush=True)
    return 1


def result_line(bench: dict, cell: dict, ob, trace: bool) -> dict:
    from . import registry

    w = ob.window
    device = {"platform": "gpu", "kind": ob.device_kind, "count": cell["chips"],
              "memory_peak_bytes": ob.memory_peak_bytes}
    obs = ob.obs if trace else ob.end_to_end()
    metrics = {}
    for m in registry.metrics_of(bench, cell["name"], trace):
        v = registry.reader(m["name"])(obs)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    if trace:
        dev = ob.obs["device"]
        device.update(busy_s=dev["busy_s"], window_s=w.seconds)
        breakdown = {"device_ops": [list(kv) for kv in dev["device_ops"]],
                     "idle_gaps": dev["idle_gaps"]}
    line = {"correct": ob.check["correct"], "attempted": w.calls, "failed": ob.failed_calls,
            "metrics": metrics, "device": device}
    if trace:
        line["breakdown"] = breakdown
    line["check"] = ob.check["numbers"]
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    from . import registry
    from .check import lines

    try:
        bench = registry.load_benchmark()
        cell = registry.cell(bench, args.workload)
        config, config_path = registry.config(bench, cell["config"])
        traffic = registry.traffic(cell["traffic"])
    except (registry.BenchError, OSError, ValueError) as e:
        return fail(str(e))
    steer = sorted(k for k in os.environ if k.startswith("HUTOKEN_TPU_"))
    if steer:
        return fail(f"refusing to run with {steer} set: they change the program's path")
    import torch

    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark measures the card and never falls back")
    if torch.cuda.device_count() < cell["chips"]:
        return fail(f"the cell asks for {cell['chips']} cards, {torch.cuda.device_count()} present")
    try:
        from .harness import run_cell

        ob = run_cell(config, config_path, traffic, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t_start=T_START,
                      kernels=registry.kernel_readers(bench, cell["name"]))
    except (registry.BenchError, ImportError) as e:
        return fail(str(e))
    line = result_line(bench, cell, ob, bool(args.trace))
    found = forbidden_modules(sys.modules)
    if found:
        return fail(f"modules of JAX or the JAX package were loaded: {found}")
    if args.trace:
        dev = ob.obs["device"]
        print(f"portbench: trace of {dev['events']} device events reduced in "
              f"{dev['reduce_s']:.3f} s", file=sys.stderr)
    print("portbench: window host use " + json.dumps(ob.host), file=sys.stderr)
    print(f"portbench: reference check {ob.reference_s:.3f} s, "
          f"{ob.check['tokens_compared']} tokens", file=sys.stderr)
    print("\n".join(lines(ob.check["numbers"])), file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
