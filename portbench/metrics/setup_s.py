"""Set-up: from the process's start to the end of the warm-up (imports,
the CUDA context, kernel and native builds where a checkout has none,
the vocabulary files, tables, the pool, ``warmup()`` and one call)."""


def read(obs):
    return obs["setup_s"]
