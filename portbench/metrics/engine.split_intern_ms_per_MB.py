"""Split and intern per MB: the producer thread's busy seconds in the
native ``split_intern_strs`` of each group (``engine.split_intern``), in
ms per MB of text.  They overlap the caller's stages."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.split_intern")
