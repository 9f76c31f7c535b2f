"""The engine's ``warmup()``, in seconds: loading each kernel library
(``nvcc`` first where a checkout has none built) and the first launch
of the primary block shape, to its synchronisation."""

from portbench.metrics import _setup


def read(obs):
    return _setup.stages(("warmup",), "seconds")
