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
"""

from __future__ import annotations

import ctypes

_done = False

M_TRIM_THRESHOLD = -1
M_MMAP_THRESHOLD = -3


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
