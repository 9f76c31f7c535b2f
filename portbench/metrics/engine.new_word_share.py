"""The share of the window's word references that were first seen in
their call (``words.new / words``); the rest were served from the word
cache or met earlier in the same call."""

from portbench.metrics import _spans


def read(obs):
    return _spans.ratio("words.new", "words")
