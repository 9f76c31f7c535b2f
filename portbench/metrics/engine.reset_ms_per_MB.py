"""Emptying the word cache per MB: the ``engine.reset_cache`` spans, which
the window runs between calls, in ms per MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.reset_cache")
