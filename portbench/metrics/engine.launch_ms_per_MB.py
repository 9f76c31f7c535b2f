"""Packing and launching per MB: the ``engine.launch`` spans (each
``flush``: ``vstack`` and ``argsort`` of the carried rows, padding,
pinned copies, the kernel launches, then handing the copies to the
drainer; the last one also starts the host tail's thread), in ms per MB
of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.launch")
