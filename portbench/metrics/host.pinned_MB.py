"""The most that the CUDA pinned host allocator held at the end of a
window's call, in MB: ``torch.cuda.host_memory_stats()``'s
``allocated_bytes.current`` (blocks in use and cached): the largest
that the program's span record read at the end of every 8th traced
``batch_encode`` (``spans.WATCH``), from the first."""

from portbench.metrics import _spans


def read(obs):
    s = _spans.summary()
    v = None if s is None else s.get("gauges", {}).get("pinned")
    return None if v is None else v / 1e6
