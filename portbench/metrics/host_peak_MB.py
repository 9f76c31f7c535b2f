"""The process's peak resident host memory when the window closes, read
by the benchmark from the operating system (``getrusage``'s
``ru_maxrss``) before the reference runs, in MB (10^6 bytes): what one
tokenization worker holds for its batch, with the Python and CUDA
runtime under it and the outputs the check keeps (the first call's, the
last's and a sample of 4, as lists)."""


def read(obs):
    peak = obs.get("host_peak_bytes") or 0
    return peak / 1e6 if peak > 0 else None
