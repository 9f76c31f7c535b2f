"""The engine's ``warmup()``: the rise of the process's high-water mark
across it, in MB: the kernel libraries and the modules the first launch
loads, and the launch's pinned staging."""

from portbench.metrics import _setup


def read(obs):
    return _setup.stages(("warmup",), "hwm_rise")
