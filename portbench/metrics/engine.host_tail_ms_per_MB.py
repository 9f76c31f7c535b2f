"""The host tail per MB: the tail thread's busy seconds encoding the
sub-block remainder on the native scalar path (``engine.host_tail``), in
ms per MB of text.  They overlap the caller's stages."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.host_tail")
