"""Bytes copied to the card per byte of the words merged there
(``bytes.h2d / bytes.device``): padded rows and lengths over the words'
own bytes."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ratio("bytes.h2d", "bytes.device")
