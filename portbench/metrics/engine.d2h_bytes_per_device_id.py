"""Bytes copied back from the card per id the card produced
(``bytes.d2h / ids.device``): each launch's packed prefix, its counts
and its token bound of slots, at 2 bytes an entry on the narrow table
and 4 on the wide one, over the ids its words merged to."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ratio("bytes.d2h", "ids.device")
