"""Allocator tuning for sandboxed/paravirtualized hosts.

The port's own copy of ``hutoken_tpu/utils/mem.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

In this class of environment a fresh page fault costs tens of
microseconds (syscall-intercepting sandboxes trap faults to userspace),
so numpy pipelines that allocate large temporaries run 10-100x below
memory bandwidth.  Pinning glibc's mmap/trim thresholds keeps freed
blocks on the heap, so repeated same-shaped temporaries reuse already
touched pages.  Best-effort: silently does nothing on non-glibc.

``cap_arenas`` is the port's own: it caps glibc's malloc arenas, so
that the heap those thresholds keep is one heap for the worker
threads, not one for each.
"""

from __future__ import annotations

import ctypes

_done = False

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3
M_ARENA_MAX = -8

# The main arena and one that every other thread shares.  An encode
# call starts new threads (the producer, the drainers, the host tail's
# worker); each new thread takes whichever arena is free then, and under
# the 1 GB trim threshold no arena shrinks, so with glibc's default (8
# arenas a core) each arena keeps its own high-water mark of the same
# short-lived buffers.
ARENA_MAX = 2
_arenas_done = False


def tune_allocator(threshold_bytes: int = 1 << 30) -> None:
    global _done
    if _done:
        return
    _done = True
    try:
        libc = ctypes.CDLL(None)
        libc.mallopt(M_MMAP_THRESHOLD, threshold_bytes)
        libc.mallopt(M_TRIM_THRESHOLD, threshold_bytes)
    except Exception:
        pass


def cap_arenas() -> None:
    """Cap glibc's malloc arenas at ``ARENA_MAX`` for the whole process,
    once.  An arena, once made, stays, so call it before the process
    starts its worker threads.  Best-effort: silently does nothing on
    non-glibc."""
    global _arenas_done
    if _arenas_done:
        return
    _arenas_done = True
    try:
        ctypes.CDLL(None).mallopt(M_ARENA_MAX, ARENA_MAX)
    except (OSError, AttributeError):
        pass
