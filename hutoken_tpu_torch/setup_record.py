"""The port's set-up record: memory and clock stamps at each stage of a
process's set-up, and around its first untraced ``batch_encode`` calls.

Set-up runs before any profiler records, so this record, unlike the
span record (``spans.py``), is always on.  It is small: at most ``CAP``
(64) stamps a process, the rest dropped and counted; each stamp keeps
what it cost.

A stamp holds its name, ``time.time_ns()`` (the clock of the span
record and of the profiler's Chrome trace) and, in bytes: ``hwm``, the
high-water mark of the process's resident memory (``getrusage``'s
``ru_maxrss``, which the benchmark's ``host_peak_MB`` also reads, and
which Linux carries over from the image an ``exec`` replaced: a process
forked from a larger one starts at that one's mark); ``VmHWM``
(``vm_hwm``), ``VmRSS``, ``RssAnon``, ``RssFile`` and ``RssShmem`` of
``/proc/self/status``; and, once the package has set ``read_pinned``,
the bytes the CUDA pinned host allocator holds.  A reading the host
cannot give is None: some sandboxed kernels give ``VmRSS`` and no other
of the status fields.  Only three stamps are full and read the status
file and the pinned bytes: where memory comes in that the program does
not allocate itself, the imports (``package``), the CUDA context
(``device_tables.end``) and the kernel libraries (``warmup.end``).  The
others read the clock and the mark, one system call, and hold None for
the rest: under a sandboxed kernel a system call made after a stretch
of other work takes 0.1 ms or stalls for milliseconds, and the status
file's ``pread`` lets the encode's other threads take the interpreter.

The stamps, in the order a process makes them:

* ``package``: the package's first line, before ``__init__.py`` imports
  anything but this module;
* ``context.start`` / ``.end``: ``initialize``'s ``TokenizerContext.load``;
* in ``TorchTokenizer.__init__``, a pair each: ``encoder_tables``,
  ``device_tables`` (the CUDA context is made there), ``replicas``,
  ``id_table`` and ``decode_fast_path``;
* ``warmup.start`` / ``.end``: ``TorchTokenizer.warmup()``, with one
  stamp after each kernel library it loads (``warmup.<library>``);
* ``call.<n>.start`` / ``.end``: the process's first ``CALLS`` (16)
  ``batch_encode`` calls made while no profiler records;
* ``window``: the first call made while one records, which starts a
  traced window.

Between the pairs lie gaps (a caller's own work: loading files, its
pool).  The high-water mark only rises, so the stages' rises and the
gaps' rises add up to the mark at the last stamp; ``summary()`` gives
both, and the last gap before ``window`` apart from the others: a
caller that starts a profiler there pays for its buffers in that gap.
A stage that a process runs twice (a second ``initialize``) is summed.

    from hutoken_tpu_torch.setup_record import SETUP

    SETUP.summary()   # per stage: seconds and rise of the mark; gaps; the mark at the end
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import os
import resource
import threading
import time
import weakref

CAP = 64
CALLS = 16
STATUS = "/proc/self/status"
_PID = os.getpid()  # set anew in a forked child (``_forked``): no system call a stamp
_FIELDS = (b"VmHWM:", b"VmRSS:", b"RssAnon:", b"RssFile:", b"RssShmem:")


def parse_status(data: bytes) -> tuple:
    """``VmHWM``, ``VmRSS``, ``RssAnon``, ``RssFile`` and ``RssShmem`` of
    a ``/proc/<pid>/status`` text in bytes, each None where it is
    missing."""
    out = []
    for key in _FIELDS:
        i = data.find(key)
        value = data[i + len(key) : data.find(b"\n", i)].split() if i >= 0 else None
        out.append(int(value[0]) * 1024 if value else None)
    return tuple(out)


def maxrss_bytes() -> int:
    """The process's high-water mark from ``getrusage`` (``ru_maxrss``,
    which Linux gives in kilobytes): one system call, where a read of
    ``/proc/self/status`` takes two and builds the whole file.  It asks
    for the calling thread's usage (``RUSAGE_THREAD``), whose
    ``ru_maxrss`` is the same mark as ``RUSAGE_SELF``'s, since threads
    share one address space, and which does not sum the CPU times of
    every thread of the process, as ``RUSAGE_SELF`` does."""
    return resource.getrusage(resource.RUSAGE_THREAD).ru_maxrss * 1024


class _Mallinfo2(ctypes.Structure):
    _fields_ = [(f, ctypes.c_size_t) for f in (
        "arena", "ordblks", "smblks", "hblks", "hblkhd", "usmblks", "fsmblks", "uordblks",
        "fordblks", "keepcost")]


@functools.cache
def _mallinfo2():
    try:
        fn = ctypes.CDLL(None).mallinfo2
    except (OSError, AttributeError):  # not glibc 2.33 or later
        return None
    fn.restype, fn.argtypes = _Mallinfo2, []
    return fn


def heap_free_bytes() -> int | None:
    """The bytes glibc's heaps hold free (``mallinfo2().fordblks``):
    freed, kept for reuse and not returned to the system.  glibc walks
    every free chunk to count them, so the cost grows with the heap's
    fragments.  None outside glibc 2.33 or later."""
    fn = _mallinfo2()
    return None if fn is None else int(fn().fordblks)


def start_ticks(stat_line: str) -> int:
    """Field 22 of a ``/proc/<pid>/stat`` line, the process's start in
    clock ticks after boot.  The command name (field 2) is in
    parentheses and may itself hold spaces and ``)``, so the fields are
    counted from after its last ``)``."""
    rest = stat_line[stat_line.rindex(")") + 1 :].split()
    return int(rest[19])  # rest[0] is field 3


def process_start_ns(stat: str = "/proc/self/stat", uptime: str = "/proc/uptime") -> int | None:
    """The process's start on the ``time.time_ns()`` clock: now, less the
    seconds since boot, plus the start's ticks after boot.  To a clock
    tick (10 ms on most hosts); None where ``/proc`` cannot say."""
    try:
        with open(stat, encoding="utf-8", errors="replace") as f:
            ticks = start_ticks(f.read())
        with open(uptime, encoding="ascii") as f:
            up = float(f.read().split()[0])
        hz = os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None
    return time.time_ns() - int((up - ticks / hz) * 1e9)


class Stamp:
    """One reading of the clock and of the process's memory, and what it
    cost (``cost_ns``)."""

    __slots__ = ("name", "ns", "hwm", "vm_hwm", "rss", "anon", "file", "shmem", "pinned",
                 "cost_ns")

    def __init__(self, name: str, ns: int, hwm: int | None, status: tuple,
                 pinned: int | None, cost_ns: int = 0):
        self.name = name
        self.ns = ns
        self.hwm = hwm
        self.vm_hwm, self.rss, self.anon, self.file, self.shmem = status
        self.pinned = pinned
        self.cost_ns = cost_ns

    def as_dict(self) -> dict:
        return {k: getattr(self, k) for k in self.__slots__}


_NOTHING = contextlib.nullcontext()
_NONE = (None,) * len(_FIELDS)


class SetupRecord:
    """The stamps of one process's set-up, in the order they were made.
    ``read_pinned``, where set, reads the pinned allocator's bytes at
    each full stamp."""

    def __init__(self, status: str = STATUS, start_ns: int | None = None):
        self.calls_made = 0  # untraced calls stamped
        self.window = False
        self.status = status
        self.start_ns = process_start_ns() if start_ns is None else start_ns
        self.read_pinned = None
        self.dropped = 0
        self.cost_ns = 0  # what stamping has cost, on the stamping threads
        self._stamps: list[Stamp] = []
        self._lock = threading.Lock()
        self._fd = self._fd_pid = None
        self._close = None

    def _status(self) -> tuple:
        """The status file read through a descriptor kept open while the
        record lives, one ``pread`` a stamp (a file of ``/proc`` is made
        anew at each read from its start); opened again in a forked
        child, whose ``/proc/self`` is another file."""
        if self._fd_pid != _PID:
            self._fd_pid = _PID
            if self._close is not None:
                self._close()
            try:
                self._fd = os.open(self.status, os.O_RDONLY)
                self._close = weakref.finalize(self, os.close, self._fd)
            except OSError:
                self._fd = self._close = None
        if self._fd is None:
            return _NONE
        try:
            return parse_status(os.pread(self._fd, 1 << 14, 0))
        except OSError:
            return _NONE

    def stamp(self, name: str, full: bool = False) -> None:
        """Stamp ``name`` now; a stamp that is not ``full`` reads only the
        clock and the mark, and holds None for the rest."""
        t0 = time.perf_counter_ns()
        if len(self._stamps) >= CAP:
            with self._lock:
                self.dropped += 1
            return
        read_pinned = self.read_pinned if full else None
        s = Stamp(name, time.time_ns(), maxrss_bytes(), self._status() if full else _NONE,
                  None if read_pinned is None else read_pinned())
        s.cost_ns = time.perf_counter_ns() - t0
        with self._lock:
            if len(self._stamps) < CAP:
                self._stamps.append(s)
            else:
                self.dropped += 1
            self.cost_ns += s.cost_ns

    @contextlib.contextmanager
    def stage(self, name: str, full: bool = False):
        """``with record.stage(name):`` stamps ``name.start`` and
        ``name.end``, the end also where the body raises, and full with
        ``full``."""
        self.stamp(name + ".start")
        try:
            yield
        finally:
            self.stamp(name + ".end", full)

    def call(self, traced: bool):
        """The stamps of one ``batch_encode`` call: a stage ``call.<n>``
        for each of the first ``CALLS`` untraced ones, one ``window``
        stamp before the first traced one, else nothing (one compare)."""
        if traced:
            if not self.window:
                self.window = True
                self.stamp("window")
            return _NOTHING
        if self.calls_made >= CALLS:
            return _NOTHING
        with self._lock:
            self.calls_made += 1
            n = self.calls_made
        return self.stage(f"call.{n}")

    def stamps(self) -> list[Stamp]:
        with self._lock:
            return list(self._stamps)

    def summary(self) -> dict:
        """What the stamps say, in seconds and bytes:

        * ``stages``: for each pair (``<name>.start`` / ``.end``) its
          ``seconds`` and ``hwm_rise`` (the mark's rise across it),
          summed over the pairs of the name, and ``outer``, whether it
          lies in no other pair;
        * ``before_program``: process start to the first stamp
          (``seconds``; ``hwm_rise`` is the mark there, from zero);
        * ``gaps``: the same for the time outside every pair after the
          first stamp, but the gap that ends at ``window``, and
          ``between``: each such gap as ``[after, before, seconds,
          hwm_rise]``, named by the stamps that bound it;
        * ``to_window``: that last gap before ``window`` (None without
          the stamp), where a caller that traces its window starts its
          profiler;
        * ``hwm``: the mark at the last stamp, which ``before_program``,
          the outer stages, ``gaps`` and ``to_window`` add up to;
          ``last``: the last stamp's name;
        * ``stamps``: each stamp as a dict; ``dropped``; ``cost_s``.

        A reading that is None makes each sum it enters None."""
        stamps = self.stamps()
        out = {"stages": {}, "before_program": None, "gaps": None, "to_window": None,
               "hwm": None, "last": None, "stamps": [s.as_dict() for s in stamps],
               "dropped": self.dropped, "cost_s": self.cost_ns / 1e9}
        if not stamps:
            return out
        first = prev = stamps[0]
        out["hwm"], out["last"] = stamps[-1].hwm, stamps[-1].name
        out["before_program"] = {
            "seconds": None if self.start_ns is None else (first.ns - self.start_ns) / 1e9,
            "hwm_rise": first.hwm,
        }
        gaps = {"seconds": 0.0, "hwm_rise": 0, "between": []}
        opened: dict[str, Stamp] = {}
        for s in stamps:
            name, _, edge = s.name.rpartition(".")
            if edge == "start":
                if not opened:
                    _add(gaps, prev, s, gaps["between"])
                opened[name] = s
            elif edge == "end" and name in opened:
                begin = opened.pop(name)
                stage = out["stages"].setdefault(
                    name, {"seconds": 0.0, "hwm_rise": 0, "outer": not opened})
                _add(stage, begin, s)
                prev = s
            elif not opened:
                if s.name == "window":
                    out["to_window"] = {"seconds": 0.0, "hwm_rise": 0}
                    _add(out["to_window"], prev, s)
                else:
                    _add(gaps, prev, s, gaps["between"])
                prev = s
        out["gaps"] = gaps
        return out


def _add(into: dict, a: Stamp, b: Stamp, between: list | None = None) -> None:
    """Add the seconds and the mark's rise from ``a`` to ``b`` to
    ``into``; list the pair in ``between``, unless it is one stamp."""
    rise = None if a.hwm is None or b.hwm is None else b.hwm - a.hwm
    into["seconds"] += (b.ns - a.ns) / 1e9
    into["hwm_rise"] = None if rise is None or into["hwm_rise"] is None else into["hwm_rise"] + rise
    if between is not None and a is not b:
        between.append([a.name, b.name, (b.ns - a.ns) / 1e9, rise])


def _forked() -> None:
    global _PID
    _PID = os.getpid()


os.register_at_fork(after_in_child=_forked)

# the process's one record, which the package stamps from its first line
SETUP = SetupRecord()
