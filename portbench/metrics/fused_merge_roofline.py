"""``csrc/fused_merge.cu``'s share of its byte roofline over the window,
both variants, in percent (``_counts.py`` counts the bytes).

The traced run wraps ``ENTRY``, the name the engine calls the kernel's
Python entry by, keeps what ``keep`` takes of each launch, and counts
the launches' work with ``work`` once the window has closed; the
kernel's device time is that of the trace's kernels whose names hold
``<KERNEL>_kernel``.
"""

from portbench.metrics import _counts

KERNEL = "fused_merge"
ENTRY = "hutoken_tpu_torch.engine:merge_words_from_bytes_fused"


def keep(args, out):
    """``(lens, packed, rows)``: ``args`` are ``(tab, raw, lens, u16_out)``."""
    _tab, raw, lens, _u16 = args
    return (lens, out, raw.shape[0])


def launches() -> int:
    """The program's own launch counters of the kernel."""
    from hutoken_tpu_torch.ops.fused_merge import merge_words_from_bytes_fused as fm

    return fm.launches + fm.wide_launches


work = _counts.fused_merge_work


def read(obs):
    return _counts.roofline_share(obs, KERNEL)
