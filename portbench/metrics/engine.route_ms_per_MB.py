"""Routing per MB: the ``engine.route`` spans (the null scan, the length
sum and, on calls of 768 K characters or more, ``_raw_probe``'s split of
a 256 KB sample), in ms per MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.route")
