"""Set-up between the program's stages: the rise of the process's
high-water mark, in MB, outside every stamped stage from the package's
first line to the last stamp before the window, which holds the
caller's own work (the native library, the vocabulary files, the
traffic pool, the cache resets).  The last gap, from there to the
window's first call, is left out: in a traced run it holds the
harness's tracer and the profiler's start (the record's
``to_window``).  With ``before_program``, the stages and that last gap
it adds up to the mark at the window's first call."""

from portbench.metrics import _setup


def read(obs):
    s = _setup.summary()
    rise = None if s is None else s["gaps"]["hwm_rise"]
    return None if rise is None else rise / 1e6
