"""The calls before the window, in seconds summed: the cell's untimed
warm-up calls of ``batch_encode`` that the set-up record stamps (the
process's first 16 untraced calls, ended before the traced window)."""

from portbench.metrics import _setup


def read(obs):
    return _setup.first_calls("seconds")
