"""The most that glibc's heaps held free at the end of a window's call,
in MB: ``mallinfo2().fordblks``, freed bytes kept for reuse and not
returned to the system (the 1 GB trim threshold that
``utils/mem.py::tune_allocator`` sets keeps them): the largest that the
program's span record read at the end of every 8th traced
``batch_encode`` (``spans.WATCH``), from the first."""

from portbench.metrics import _spans


def read(obs):
    s = _spans.summary()
    v = None if s is None else s.get("gauges", {}).get("heap_free")
    return None if v is None else v / 1e6
