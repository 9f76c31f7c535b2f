"""How far the window's calls raised the process's peak: the rise of
``ru_maxrss`` across each traced ``facade.batch_encode`` span, summed,
in MB (``hutoken_tpu_torch/spans.py``).  It is read in the traced run,
whose profiler holds its event buffers in the same process: the rise
includes them, and reads above what an untraced window adds."""

from portbench.metrics import _spans


def read(obs):
    s = _spans.summary()
    if s is None or "hwm_rise" not in s["spans"].get("facade.batch_encode", {}):
        return None
    return s["spans"]["facade.batch_encode"]["hwm_rise"] / 1e6
