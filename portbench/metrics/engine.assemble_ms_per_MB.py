"""Assembly per MB: the ``engine.assemble`` spans (the device words'
spans into the pool, the tail's, and ``native.assemble`` of the
per-document streams), in ms per MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.assemble")
