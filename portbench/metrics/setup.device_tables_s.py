"""The engine's ``device_tables`` call, in seconds: the narrow table's
host packing, the CUDA context, which the first upload makes, and the
tables' upload."""

from portbench.metrics import _setup


def read(obs):
    return _setup.stages(("device_tables",), "seconds")
