"""The caller waiting for the last copies back per MB: the
``engine.device_wait`` spans (``drainer.join()``), in ms per MB of
text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.device_wait")
