"""The facade's own time per MB, read inside the program: the self seconds
of the ``facade.batch_encode`` spans (each call less its
``engine.encode_core`` child: ``encode_batch``'s per-document lists and
the facade around them), in ms per MB of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "facade.batch_encode", "self_s")
