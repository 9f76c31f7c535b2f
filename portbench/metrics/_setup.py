"""What the program's set-up record holds (``hutoken_tpu_torch/
setup_record.py``), for the readers of the ``setup`` layer.

The record is always on: it stamps the clock and the process's memory
(``VmHWM`` and the rest of ``/proc/self/status``) around each stage of
set-up and the process's first untraced calls, and once more at the
first traced call, where the traced window starts.  A reader takes what
the stamps say and reads nothing of the process itself: ``run.py``
reads the metrics after the reference check, which sets its own peak.

A stage's ``_s`` is its seconds, its ``_MB`` the rise of the process's
high-water mark across it in MB (10^6 bytes).  The mark only rises, so
``before_program``, the stages, the gaps between them and the last gap
before the window (the record's ``to_window``, where a traced run
starts its profiler) add up to the mark at the window's first call.  A
program without the record, or a record without the stages, gives
None.
"""

from __future__ import annotations

# ``initialize``'s context load and the engine's host build: every
# stage of the engine's own but ``device_tables``
HOST_BUILD = ("context", "encoder_tables", "replicas", "id_table", "decode_fast_path")


def summary() -> dict | None:
    """The set-up record's summary, or None where it holds no stamp."""
    try:
        from hutoken_tpu_torch.setup_record import SETUP
    except ImportError:
        return None
    s = SETUP.summary()
    return s if s["stamps"] else None


def _in_units(value, key: str):
    if value is None:
        return None
    return value / 1e6 if key == "hwm_rise" else value


def stages(names, key: str) -> float | None:
    """``key`` (``seconds`` or ``hwm_rise``) summed over the stages
    ``names``, in seconds or MB; None unless each was stamped."""
    s = summary()
    if s is None or not all(n in s["stages"] for n in names):
        return None
    values = [s["stages"][n][key] for n in names]
    return None if None in values else _in_units(sum(values), key)


def before_program(key: str) -> float | None:
    """Process start to the package's first line: its seconds, or the
    high-water mark there (a rise from nothing) in MB."""
    s = summary()
    return None if s is None else _in_units(s["before_program"][key], key)


def first_calls(key: str) -> float | None:
    """``key`` summed over the stamped calls (``call.<n>``) that ended
    before the traced window began (all of them in a run without one),
    in seconds or MB; None without such a call."""
    s = summary()
    if s is None:
        return None
    stamps = s["stamps"]
    window = next((x["ns"] for x in stamps if x["name"] == "window"), None)
    field = "ns" if key == "seconds" else "hwm"
    starts, total, calls = {}, 0, 0
    for x in stamps:
        name, _, edge = x["name"].rpartition(".")
        if not name.startswith("call."):
            continue
        if edge == "start":
            starts[name] = x
        elif edge == "end" and name in starts and (window is None or x["ns"] <= window):
            a, b = starts.pop(name)[field], x[field]
            if a is None or b is None:
                return None
            total += b - a
            calls += 1
    if not calls:
        return None
    return total / 1e9 if key == "seconds" else total / 1e6
