"""Set-up before the program: the seconds from the process's start
(``/proc/self/stat``) to the package's first line, which hold the
interpreter's start, ``torch`` and the harness's own imports."""

from portbench.metrics import _setup


def read(obs):
    return _setup.before_program("seconds")
