"""The port's own spans and counts: where an encode call spends its host
time, stage by stage, on the clock of ``torch.profiler``'s trace.

The record keeps nothing unless a ``torch.profiler`` records on the
thread that enters a call.  The check runs once a call, at its
outermost entry (``batch_encode``, ``_encode_core`` called directly,
``reset_cache``); the call's worker threads never ask the profiler,
which reads as off on them, but open their spans under a span the
caller hands them.  With the profiler off every span site costs one
branch, and nothing is stamped or stored.

A span holds its name, its parent, the call's id (shared by every span
of the call, worker threads' included), its OS thread, and its start
and end in ``time.time_ns()``: the Unix clock, which ``torch.profiler``'s
Chrome trace also uses (``ts`` in us after its ``baseTimeNanoseconds``),
so the spans line up with the device trace.  Counts ride on the span of
the call entry they belong to.

    from torch.profiler import profile
    from hutoken_tpu_torch.spans import RECORD

    with profile() as prof:
        hutoken_tpu_torch.batch_encode(texts)
    RECORD.summary()  # per span name: count, total and self seconds; counts
    prof.export_chrome_trace("trace.json")
    RECORD.append_to_chrome_trace("trace.json")

Each traced ``facade.batch_encode`` span counts the rise of the
process's high-water mark (``ru_maxrss``) across it, in bytes
(``hwm_rise``): how far the call raised the process's peak.  Every
``WATCH``-th (8th) of them, from the first, is watched: each of its
stages counts its own rise, so that the summary says which stage sets a
call's peak, and at its end the record reads two gauges and keeps the
largest of each: the bytes glibc's heaps hold free
(``mallinfo2().fordblks``) and the bytes the CUDA pinned host allocator
holds (``allocated_bytes.current``; None while CUDA is not initialised);
its span counts glibc's malloc arenas (``heap.arenas``, from
``malloc_info``), which ``utils/mem.py::cap_arenas`` caps.
Only one call in ``WATCH`` pays for them: on a host where a system call
costs 3-5 us a watched call's readings took 0.3-0.5 ms, and every other
call's two reads of the mark some 10 us.  Stages that overlap on other threads (``engine.split_intern``
on the producer beside the caller's ``engine.split_wait``) may each see
the same rise.

Spans stay in memory until ``clear()``; past ``cap`` (2^20) they are
dropped and counted in ``dropped``.  The process keeps one record,
``RECORD``, which the engine holds as ``spans``: the profiler it follows
is the process's, a call's spans run from the facade into the engine,
and the host backend's calls build no engine.
"""

from __future__ import annotations

import itertools
import json
import os
import threading
import time

import torch

from .setup_record import heap_arenas, heap_free_bytes, maxrss_bytes

CAP = 1 << 20
WATCH = 8


def pinned_bytes() -> int | None:
    """The bytes the CUDA pinned host allocator holds
    (``allocated_bytes.current`` of ``host_memory_stats()``), or None while CUDA is not
    initialised in this process, where no pinned buffer can exist yet,
    and where torch cannot say."""
    # the nested form: ``host_memory_stats()`` flattens and sorts it
    stats = getattr(torch.cuda, "host_memory_stats_as_nested_dict", None)
    if stats is None or not torch.cuda.is_initialized():
        return None
    return int(stats().get("allocated_bytes", {}).get("current", 0))


class Span:
    """One timed stage, opened when it is made and kept when closed.
    ``parent`` is the parent's ``sid`` (0 for a call's first span);
    ``counts`` holds the counts of a call entry's span, added on the
    thread that entered the call.  A span of a watched call (``watch``),
    or one opened with ``mark``, reads the process's high-water mark at
    its start (``hwm0``) and keeps its rise at its end (``hwm_rise``,
    bytes); any other keeps ``hwm0`` None and a rise of 0."""

    __slots__ = ("record", "name", "sid", "parent", "call", "tid", "start_ns", "end_ns",
                 "counts", "watch", "hwm0", "hwm_rise")

    def __init__(self, record: "SpanRecord", name: str, parent: int, call: int,
                 watch: bool = False, mark: bool = False):
        self.record = record
        self.name = name
        self.sid = next(record._sids)
        self.parent = parent
        self.call = call
        self.tid = _native_tid()
        self.counts = None
        self.end_ns = 0
        self.watch = watch
        self.hwm_rise = 0
        self.hwm0 = maxrss_bytes() if watch or mark else None
        self.start_ns = time.time_ns()

    def child(self, name: str) -> "Span":
        """``name``, opened now on the calling thread, under this span."""
        return Span(self.record, name, self.sid, self.call, self.watch)

    def close(self) -> None:
        self.end_ns = time.time_ns()
        if self.hwm0 is not None:
            self.hwm_rise = maxrss_bytes() - self.hwm0
        self.record._keep(self)

    def count(self, name: str, n: int = 1) -> None:
        if self.counts is None:
            self.counts = {}
        self.counts[name] = self.counts.get(name, 0) + n


class _Entry:
    """An entry of a call, as a context manager that gives its span or
    None.  Inside a call open on this thread the span is the innermost
    entry's child; outside one it opens a new call while a profiler
    records, and otherwise marks the call untraced, so that the entries
    inside it do not ask the profiler again.  With ``gauges`` a traced
    call that it opens counts its rise of the high-water mark, and every
    ``WATCH``-th such call is watched: its stages count theirs, and it
    reads the record's gauges at its end."""

    __slots__ = ("record", "name", "gauges", "outer", "span")

    def __init__(self, record: "SpanRecord", name: str, gauges: bool = False):
        self.record = record
        self.name = name
        self.gauges = gauges

    def __enter__(self):
        rec = self.record
        outer = getattr(rec._local, "span", None)
        if outer is None:
            if torch.autograd._profiler_enabled():
                watch = self.gauges and rec._watch_next()
                span = Span(rec, self.name, 0, next(rec._calls), watch, self.gauges)
            else:
                span = False
        else:
            span = outer and outer.child(self.name)
        self.outer = outer
        self.span = span
        rec._local.span = span
        return span or None

    def __exit__(self, *exc) -> None:
        self.record._local.span = self.outer
        if self.span:
            self.span.close()
            if self.outer is None and self.span.watch:
                self.record._read_gauges(self.span)


class SpanRecord:
    """The spans of the traced calls, in the order they closed."""

    def __init__(self, cap: int = CAP):
        self.cap = cap
        self.dropped = 0
        self._spans: list[Span] = []
        self._lock = threading.Lock()
        self._sids = itertools.count(1)
        self._calls = itertools.count(1)
        self._local = threading.local()
        self.heap_free = None
        self.pinned = None
        self.gauge_ns = 0
        self.gauge_reads = 0
        self._gauged = 0  # traced calls opened with gauges

    def _watch_next(self) -> bool:
        """Whether the next traced call with gauges is watched: the
        first, then every ``WATCH``-th."""
        with self._lock:
            n = self._gauged
            self._gauged += 1
        return n % WATCH == 0

    def entry(self, name: str, gauges: bool = False) -> _Entry:
        """``with record.entry(name) as span:`` at an entry of a call;
        ``span`` is None when the call is not traced.  With ``gauges``
        a traced call counts its rise of the high-water mark, and the
        watched ones their stages' rises and the gauges (``_Entry``)."""
        return _Entry(self, name, gauges)

    def _read_gauges(self, span: Span) -> None:
        """Keep the largest of each gauge, and count the arenas on the
        watched call's ``span``."""
        t0 = time.perf_counter_ns()
        heap, pinned, arenas = heap_free_bytes(), pinned_bytes(), heap_arenas()
        if arenas is not None:
            span.count("heap.arenas", arenas)
        with self._lock:
            if heap is not None and (self.heap_free is None or heap > self.heap_free):
                self.heap_free = heap
            if pinned is not None and (self.pinned is None or pinned > self.pinned):
                self.pinned = pinned
            self.gauge_reads += 1
            self.gauge_ns += time.perf_counter_ns() - t0

    def current(self) -> Span | None:
        """The innermost entry's span open on this thread, or None."""
        return getattr(self._local, "span", None) or None

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to ``name`` on the innermost entry's span open on
        this thread; nothing outside a traced call."""
        span = getattr(self._local, "span", None)
        if span:
            span.count(name, n)

    def _keep(self, span: Span) -> None:
        with self._lock:
            if len(self._spans) < self.cap:
                self._spans.append(span)
            else:
                self.dropped += 1

    def spans(self) -> list[Span]:
        with self._lock:
            return list(self._spans)

    def clear(self) -> None:
        with self._lock:
            self._spans = []
            self.dropped = 0
            self.heap_free = self.pinned = None
            self.gauge_ns = self.gauge_reads = self._gauged = 0

    def summary(self) -> dict:
        """``spans``: for each name, ``count``, ``total_s`` and ``self_s``
        (total less the union of the same thread's children),
        ``marked`` (the spans that read the high-water mark),
        ``hwm_rise`` (their rises, bytes, summed) and ``hwm_rises`` (those
        that raised it); ``counts`` summed over every span; ``calls``
        (distinct call ids); ``dropped``; ``gauges``: the largest
        ``heap_free`` and ``pinned`` bytes at a watched call's end (None
        where none was read), ``reads``, the watched calls, and
        ``cost_s``, the seconds their reading took (the arena counts
        included, which ride on the watched spans' ``counts``)."""
        spans = self.spans()
        by_sid = {s.sid: s for s in spans}
        kids: dict[int, list] = {}
        for s in spans:
            p = by_sid.get(s.parent)
            if p is not None and p.tid == s.tid:
                kids.setdefault(p.sid, []).append((s.start_ns, s.end_ns))
        names: dict[str, dict] = {}
        counts: dict[str, int] = {}
        for s in spans:
            total = s.end_ns - s.start_ns
            inner = _covered_ns(kids.get(s.sid, ()), s.start_ns, s.end_ns)
            e = names.setdefault(s.name, {"count": 0, "total_s": 0.0, "self_s": 0.0,
                                          "marked": 0, "hwm_rise": 0, "hwm_rises": 0})
            e["count"] += 1
            e["total_s"] += total / 1e9
            e["self_s"] += (total - inner) / 1e9
            e["marked"] += s.hwm0 is not None
            e["hwm_rise"] += s.hwm_rise
            e["hwm_rises"] += s.hwm_rise > 0
            for k, v in (s.counts or {}).items():
                counts[k] = counts.get(k, 0) + v
        with self._lock:
            gauges = {"heap_free": self.heap_free, "pinned": self.pinned,
                      "reads": self.gauge_reads, "cost_s": self.gauge_ns / 1e9}
        return {"spans": names, "counts": counts, "calls": len({s.call for s in spans}),
                "dropped": self.dropped, "gauges": gauges}

    def append_to_chrome_trace(self, path: str) -> int:
        """Append the spans to the Chrome trace that ``torch.profiler``
        exported to ``path``, on its clock (``ts`` in us after its
        ``baseTimeNanoseconds``), as complete events of category
        ``hutoken``: one ``tid`` a thread, the call id and any counts in
        ``args``.  Returns how many."""
        with open(path, encoding="utf-8") as f:
            trace = json.load(f)
        base = int(trace.get("baseTimeNanoseconds", 0))
        pid = os.getpid()
        events = [
            {"ph": "X", "cat": "hutoken", "name": s.name, "pid": pid, "tid": s.tid,
             "ts": (s.start_ns - base) / 1e3, "dur": (s.end_ns - s.start_ns) / 1e3,
             "args": {"call": s.call, **(s.counts or {})}}
            for s in self.spans()
        ]
        trace.setdefault("traceEvents", []).extend(events)
        with open(path, "w", encoding="utf-8") as f:
            json.dump(trace, f)
        return len(events)


_THREAD = threading.local()


def _native_tid() -> int:
    """The OS id of the calling thread, read once a thread: it is a
    system call, which costs microseconds on some hosts."""
    try:
        return _THREAD.tid
    except AttributeError:
        _THREAD.tid = threading.get_native_id()
        return _THREAD.tid


def _covered_ns(intervals, lo: int, hi: int) -> int:
    """Length of the union of ``intervals`` clipped to ``[lo, hi]``."""
    covered = 0
    end = lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            covered += e - s
            end = e
    return covered


# the process's one record: the profiler it follows is the process's too
RECORD = SpanRecord()
