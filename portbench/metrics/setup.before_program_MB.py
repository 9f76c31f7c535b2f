"""Set-up before the program: the process's high-water mark at the
package's first line, in MB, a rise from nothing at the process's
start: the interpreter, ``torch`` and the harness's own imports."""

from portbench.metrics import _setup


def read(obs):
    return _setup.before_program("hwm_rise")
