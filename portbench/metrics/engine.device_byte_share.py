"""The share of the new words' bytes merged on the card
(``bytes.device / bytes.new``); the rest are one-byte words, the host
tail and words past 128 bytes."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ratio("bytes.device", "bytes.new")
