"""What the program's own span record holds of the traced window, for the
readers of its stages and counts (``hutoken_tpu_torch/spans.py``).

The program keeps spans only while ``torch.profiler`` records on the
calling thread, and the traced run's profiler covers the window alone
(``trace.Tracer.start`` / ``stop``): not the set-up, not the check.  The
CPU rehearsal runs no profiler and a program without the record has none
to read: each reader then gives None.  A stage's seconds are summed over
its spans, on whatever thread each ran.
"""

from __future__ import annotations


def summary() -> dict | None:
    """The engine's span summary, or None where it holds no span."""
    import hutoken_tpu_torch as ht

    record = getattr(ht._get_engine(), "spans", None)
    if record is None:
        return None
    s = record.summary()
    return s if s["spans"] else None


def ms_per_MB(obs: dict, name: str, key: str = "total_s") -> float | None:
    """``key`` seconds of the spans named ``name``, in ms per MB of text."""
    s = summary()
    if s is None or not obs.get("mb") or name not in s["spans"]:
        return None
    return 1e3 * s["spans"][name][key] / obs["mb"]


def ratio(numerator: str, denominator: str) -> float | None:
    """One count of the window's calls over another."""
    s = summary()
    if s is None or not s["counts"].get(denominator):
        return None
    return s["counts"].get(numerator, 0) / s["counts"][denominator]
