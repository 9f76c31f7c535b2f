"""The traced window's rate at the entry users call: UTF-8 bytes of
every document of every ``batch_encode`` call over the window's seconds,
in MB/s (1 MB = 10^6 bytes), with the benchmark's timers and the
profiler running."""


def read(obs):
    if not obs["window_s"]:
        return None
    return obs["mb"] / obs["window_s"]
