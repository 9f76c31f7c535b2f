"""The traced run's instruments, all from the benchmark's side.

:class:`Tracer` puts timers around calls into the program's layers
without changing the program:

* the facade engine's ``_encode_core`` (an attribute of that one
  object), whose span is the engine's share of a call;
* the kernel entries that the cell's kernel readers name (``ENTRY`` in
  ``metrics/<metric>.py``), each of which keeps what the reader's
  ``keep`` takes of a launch, so that the reader's ``work`` can count
  the bytes once the window has closed;
* the program's own launch counters, read before and after the window
  (each kernel reader's ``launches()``).

With ``profile`` it runs ``torch.profiler`` (CPU and CUDA activity) over
the window and reduces its trace to the device's busy seconds (the union
of kernel, copy and set intervals), each kernel's device seconds, the
device operations that took most time, and the idle seconds between the
first call's start and the last call's end split by what the caller's
thread was doing: inside ``_encode_core``, in the facade outside it, or
between calls.
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
import time

from .registry import BenchError

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
CALL_SPAN = "portbench.call"
CORE_SPAN = "portbench.encode_core"
HOST_CORE = "engine._encode_core"
HOST_FACADE = "facade: batch_encode outside _encode_core"
HOST_HARNESS = "harness: between calls"


def union_seconds(intervals) -> tuple[float, list]:
    """Length of the union of ``(start, end)`` intervals, and the merged
    intervals in order."""
    merged: list = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return sum(e - s for s, e in merged), merged


def reduce_trace(events: list) -> dict:
    """Reduce Chrome-trace events (times in us) to seconds."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    busy_us, merged = union_seconds((e["ts"], e["ts"] + e["dur"]) for e in dev)
    by_name: dict = {}
    for e in dev:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e["dur"] / 1e6
    spans = {CALL_SPAN: [], CORE_SPAN: []}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation" and e.get("name") in spans:
            spans[e["name"]].append((e["ts"], e["ts"] + e["dur"]))
    calls = sorted(spans[CALL_SPAN])
    idle: dict = {}
    if calls:
        in_call, in_core = Coverage(calls), Coverage(spans[CORE_SPAN])
        edges = [calls[0][0]] + [x for s, e in merged for x in (s, e)] + [calls[-1][1]]
        for s, e in zip(edges[0::2], edges[1::2]):
            if e > s:
                core, call = in_core.within(s, e), in_call.within(s, e)
                for name, us in ((HOST_CORE, core), (HOST_FACADE, call - core),
                                 (HOST_HARNESS, e - s - call)):
                    idle[name] = idle.get(name, 0.0) + us / 1e6
    return {
        "busy_s": busy_us / 1e6,
        "events": len(dev),
        "kernel_s": by_name,
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in idle.items() if v > 0), key=lambda kv: -kv[1]),
    }


class Coverage:
    """How much of an interval the union of some spans covers."""

    def __init__(self, spans):
        _total, self.spans = union_seconds(spans)
        self.starts = [s for s, _e in self.spans]
        self.before = [0.0]  # covered time before each span
        for s, e in self.spans:
            self.before.append(self.before[-1] + e - s)

    def upto(self, t: float) -> float:
        i = bisect.bisect_right(self.starts, t)
        if i == 0:
            return 0.0
        s, e = self.spans[i - 1]
        return self.before[i - 1] + min(t, e) - s

    def within(self, s: float, e: float) -> float:
        return self.upto(e) - self.upto(s)


def attach_device_times(works: dict, dev: dict, launches: dict) -> None:
    """Give each kernel's work its device seconds (its kernels' names
    hold ``<kernel>_kernel``).  Raises where the trace holds no device
    event at all (the launch counters moved or not: a cell's traced run
    drives the card), or no event of a kernel that launched: such a
    trace would read a share of 0 where the kernel ran."""
    ran = {k: v for k, v in launches.items() if v}
    if not dev["events"]:
        raise BenchError(
            "the profiler saw no device event in the window (launch counters moved: "
            f"{ran or 'none'}); the cell's traffic has to reach the card in every traced run"
        )
    for name, work in works.items():
        work["device_s"] = sum(s for k, s in dev["kernel_s"].items() if f"{name}_kernel" in k)
        if work["launches"] and not work["device_s"]:
            raise BenchError(
                f"{work['launches']} {name} launches in the window and no such kernel in the trace"
            )


class Tracer:
    """Timers, kernel-entry records and, with ``profile``, the profiler
    over one window.  ``kernels`` are the kernel readers of the cell's
    per-layer metrics."""

    def __init__(self, engine, profile: bool, kernels=()):
        self.engine = engine
        self.profile = profile
        self.kernels = {m.KERNEL: m for m in kernels}
        self.core_s = 0.0
        self.records = {k: [] for k in self.kernels}
        self._undo: list = []
        self._prof = None

    def _patch(self, obj, name: str, new) -> None:
        self._undo.append((obj, name, getattr(obj, name), name in vars(obj)))
        setattr(obj, name, new)

    def _wrap_entry(self, reader) -> None:
        import importlib

        module, _, attr = reader.ENTRY.partition(":")
        owner = importlib.import_module(module)
        entry = getattr(owner, attr)
        records = self.records[reader.KERNEL]

        def wrapped(*args):
            out = entry(*args)
            records.append(reader.keep(args, out))
            return out

        self._patch(owner, attr, wrapped)

    def install(self) -> None:
        import torch

        core = self.engine._encode_core
        record = torch.profiler.record_function

        def timed_core(texts):
            t = time.perf_counter()
            try:
                with record(CORE_SPAN):
                    return core(texts)
            finally:
                self.core_s += time.perf_counter() - t

        self._patch(self.engine, "_encode_core", timed_core)
        for reader in self.kernels.values():
            self._wrap_entry(reader)

    def uninstall(self) -> None:
        for obj, name, old, own in reversed(self._undo):
            if own:
                setattr(obj, name, old)
            else:
                delattr(obj, name)
        self._undo.clear()

    def wrap_call(self, encode):
        import torch

        record = torch.profiler.record_function

        def call(batch):
            with record(CALL_SPAN):
                return encode(batch)

        return call

    def launch_counters(self) -> dict:
        return {k: m.launches() for k, m in self.kernels.items()}

    def start(self) -> None:
        self.counters0 = self.launch_counters()
        if self.profile:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self._prof.__enter__()

    def stop(self) -> dict:
        """Close the profiler; returns what the window's counters moved."""
        import torch

        if self._prof is not None:
            torch.cuda.synchronize()
            self._prof.__exit__(None, None, None)
        counters = self.launch_counters()
        return {"launches": {k: counters[k] - self.counters0[k] for k in counters},
                "core_s": self.core_s}

    def works(self) -> dict:
        """Each kernel's work over the window, by its reader's count; the
        records are dropped."""
        out = {k: m.work(self.records[k]) for k, m in self.kernels.items()}
        self.records = {k: [] for k in self.kernels}
        return out

    def device_trace(self) -> dict:
        """The reduced trace; the file goes to ``TMPDIR`` and is deleted."""
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            with open(path, encoding="utf-8") as f:
                events = json.load(f).get("traceEvents", [])
        finally:
            os.remove(path)
        self._prof = None
        return reduce_trace(events)
