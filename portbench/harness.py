"""One run of one cell: set-up, the timed window, the traced readings and
the check.

Set-up (timed as ``setup_s`` from the process's start): the native host
library, the configuration's vocabulary files (by the writer the
configuration names), ``initialize(...)`` with
the configuration's options and the engine the facade builds, the
traffic pool from the seed, the engine's ``warmup()`` and the traffic's
``warmup_calls`` untimed calls of the cell's own batches, each followed
by emptying the word cache: every window starts a job on a cold cache.
Their outputs are dropped at once, as the window drops every output
that the check does not keep.

The window drives ``hutoken_tpu_torch.batch_encode``, the entry users
call (``window.run_window``); with ``reset_per_pass`` the cache is
emptied again at every wrap of the pool.  A traced run adds the
benchmark's timers and, on the card, ``torch.profiler`` (``trace.py``).
After the window the kept outputs are compared with the plain reference
that the configuration names (``check.py``).

:func:`run_cell` returns the observations; ``run.py`` turns them into
the result line.  On ``device="cpu"`` it runs the program's plain twins:
a rehearsal whose times are the CPU's and are never reported.
"""

from __future__ import annotations

import gc
import resource
import sys
import time
import traceback
from dataclasses import dataclass, field

from . import check, registry
from .pool import make_pool, seed_of
from .trace import Tracer, attach_device_times
from .window import run_window

CHECK_SEED = 0x5EED


@dataclass
class Observations:
    setup_s: float = 0.0
    window: object = None
    failed_calls: int = 0
    memory_peak_bytes: int = 0
    device_kind: str = ""
    obs: dict = field(default_factory=dict)  # the traced run's readings
    check: dict = field(default_factory=dict)
    reference_s: float = 0.0
    host: dict = field(default_factory=dict)  # the process's CPU seconds in the window
    host_peak_bytes: int = 0  # the process's peak resident memory when the window closed

    def end_to_end(self) -> dict:
        """The untraced run's readings, as the end-to-end readers take them."""
        w = self.window
        return {"nbytes": w.nbytes, "window_s": w.seconds,
                "setup_s": self.setup_s, "host_peak_bytes": self.host_peak_bytes}


def _counting(encode, box: list):
    """``encode`` that records a call that raises as failed (its output
    None) and goes on."""

    def call(batch):
        try:
            return encode(batch)
        except Exception:  # noqa: BLE001 - the run counts it and reports it
            if not box:
                traceback.print_exc(file=sys.stderr)
            box.append(1)
            return None

    return call


def vocab_files(config: dict, config_path: str, cache: str | None = None) -> dict:
    """The files hutoken loads (``vocab``, ``special``, ``merges``), by
    the writer the configuration names."""
    return registry.named(config["files"]["writer"], "gen")(config, config_path, cache)


def reference(config: dict, files: dict, rank_shift: int = 0):
    """The configuration's plain reference over ``files``, with the
    options the configuration hands to ``initialize``."""
    return registry.named(config["reference"], "reference")(
        files["vocab"], files["special"], files["merges"], rank_shift=rank_shift,
        **config["initialize"])


def run_cell(config: dict, config_path: str, traffic: dict, seed: int, seconds: float,
             trace: bool, device: str = "cuda", t_start: float | None = None,
             cache: str | None = None, kernels=()) -> Observations:
    """One run; ``kernels`` are the kernel readers of the cell's
    per-layer metrics, which a traced run wraps."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    import hutoken_tpu_torch as ht
    from hutoken_tpu_torch.native import load_native

    if load_native() is None:
        raise registry.BenchError("the native host library (native/) did not load")
    files = vocab_files(config, config_path, cache)
    ht.initialize(files["vocab"], files["special"], merges_file_path=files["merges"],
                  device=device, **config["initialize"])
    engine = ht._get_engine()
    wide = bool(engine.dev_tables.wide)
    if wide != (config["table"] == "wide"):
        raise registry.BenchError(
            f"the engine took the {'wide' if wide else 'narrow'} table; "
            f"the configuration states {config['table']}"
        )
    pool = make_pool(traffic, seed)
    engine.warmup()
    # the cell's own calls: the first ones grow the engine's buffers and
    # tables to the batch's size
    for i in range(int(traffic["warmup_calls"])):
        ht.batch_encode(pool.batches[i % len(pool.batches)])
        engine.reset_cache()
    if device == "cuda":
        torch.cuda.synchronize()
    gc.collect()
    ob = Observations(setup_s=time.perf_counter() - t_start)

    failed: list = []
    encode = _counting(ht.batch_encode, failed)
    tracer = None
    if trace:
        tracer = Tracer(engine, profile=(device == "cuda"), kernels=kernels)
        tracer.install()
        encode = tracer.wrap_call(encode)
        tracer.start()
    on_wrap = engine.reset_cache if traffic.get("reset_per_pass") else None
    # a window runs at least the calls the check keeps, so that a slow
    # program is late, and is judged by what it says
    calls = int(traffic["check_calls"])
    before = resource.getrusage(resource.RUSAGE_SELF)
    ob.window = run_window(
        encode, pool.batches, pool.call_bytes, seconds, on_wrap=on_wrap,
        sample=calls - 2, seed=seed_of(seed), min_calls=calls,
    )
    after = resource.getrusage(resource.RUSAGE_SELF)
    ob.host = {"user_s": after.ru_utime - before.ru_utime, "sys_s": after.ru_stime - before.ru_stime}
    # read before the reference runs, which would set its own peak
    ob.host_peak_bytes = after.ru_maxrss * 1024  # Linux gives kilobytes
    ob.failed_calls = len(failed)
    if trace:
        moved = tracer.stop()
        tracer.uninstall()
    if device == "cuda":
        torch.cuda.synchronize()
        ob.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
        ob.device_kind = torch.cuda.get_device_name()
    if trace:
        ob.obs = observe(tracer, moved, ob, device)

    t = time.perf_counter()
    ref = reference(config, files)
    docs = int(traffic["check_docs"])
    ob.check = check.compare(ob.window.kept, pool.batches, ref, docs, docs * calls,
                             seed_of(seed) ^ CHECK_SEED, ob.failed_calls)
    ob.reference_s = time.perf_counter() - t
    return ob


def observe(tracer: Tracer, moved: dict, ob: Observations, device: str) -> dict:
    """The traced run's readings, as the metric readers take them."""
    from .metrics import _counts

    w = ob.window
    obs = dict(moved)
    obs.update(mb=w.nbytes / 1e6, window_s=w.seconds, call_s=sum(w.latencies), device=None)
    works = tracer.works()
    if device == "cuda":
        t = time.perf_counter()
        dev = tracer.device_trace()
        dev["reduce_s"] = time.perf_counter() - t
        attach_device_times(works, dev, moved["launches"])
        obs["device"] = dev
        obs["peak_bytes_per_s"] = _counts.peak_bytes_per_s(ob.device_kind)
    obs["kernels"] = works
    return obs
