"""The caller waiting for the producer per MB: the ``engine.split_wait``
spans (each ``splitq.get()``; before the first, cutting the groups and
starting the threads; after the last, joining the producer), in ms per
MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.split_wait")
