"""The engine's ``device_tables`` call: the rise of the process's
high-water mark across it, in MB: the table's host packing, the CUDA
context with the libraries it maps, and the upload's staging."""

from portbench.metrics import _setup


def read(obs):
    return _setup.stages(("device_tables",), "hwm_rise")
