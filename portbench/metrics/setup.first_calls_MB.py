"""The calls before the window: the rise of the process's high-water
mark across the cell's untimed warm-up calls of ``batch_encode``, in MB
summed (each call's own rise; what lies between them, the cache resets,
is in the gaps)."""

from portbench.metrics import _setup


def read(obs):
    return _setup.first_calls("hwm_rise")
