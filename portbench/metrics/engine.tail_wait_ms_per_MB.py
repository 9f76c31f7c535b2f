"""The caller waiting for the host tail per MB: the ``engine.tail_wait``
spans (``tail_thread.join()``), in ms per MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.tail_wait")
