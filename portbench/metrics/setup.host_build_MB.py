"""The host's build: the rise of the process's high-water mark, in MB,
across ``initialize``'s context load and the engine's host stages (the
encoder tables, the replicas, the id table, the decode fast path), all
of the engine's stamped build but ``device_tables``."""

from portbench.metrics import _setup


def read(obs):
    return _setup.stages(_setup.HOST_BUILD, "hwm_rise")
