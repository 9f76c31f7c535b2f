"""Resolving each group's first-seen words per MB: the ``engine.resolve``
spans (gid capacity, ``_resolve_new_bytes``: one-byte seeds, packed rows
carried for the device, words past 128 bytes on the host), in ms per MB
of text."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ms_per_MB(obs, "engine.resolve")
