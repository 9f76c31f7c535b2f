"""The work a kernel's launches did, counted from their inputs and outputs,
and its share of the byte roofline.

The count reads the same work whatever implements the kernel: each real
byte of the words once (never a padding byte, a length, an offset or the
pair table) and each output id once, at 4 bytes, the int32 the API
returns.  The least time the card could take is those bytes over its
published memory bandwidth (``portbench/peaks.json``); the share is that
time over the device time of the kernel's launches in the trace.
"""

from __future__ import annotations

import json
import os

PEAKS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "peaks.json")
ID_BYTES = 4


def fused_merge_work(launches) -> dict:
    """``(lens, packed, rows)`` of each launch: the packed layout starts
    with the ``rows`` token counts."""
    import torch

    in_bytes = sum(int(lens.to(torch.int64).sum()) for lens, _out, _rows in launches)
    out_ids = sum(int(out[:rows].to(torch.int64).sum()) for _lens, out, rows in launches)
    return {"launches": len(launches), "in_bytes": in_bytes, "out_ids": out_ids}


def bound_bytes(work: dict) -> int:
    return work["in_bytes"] + ID_BYTES * work["out_ids"]


def peak_bytes_per_s(device_name: str) -> float | None:
    """The published memory bandwidth of the card, by the first entry of
    ``peaks.json`` whose key is part of its name."""
    with open(PEAKS, encoding="utf-8") as f:
        peaks = json.load(f)
    for key, entry in peaks.items():
        if key in device_name:
            return float(entry["memory_bytes_per_s"])
    return None


def roofline_share(obs: dict, kernel: str) -> float | None:
    """Percent of the byte roofline, or None where the kernel did not
    run in the window or no device time was traced."""
    k = obs.get("kernels", {}).get(kernel)
    peak = obs.get("peak_bytes_per_s")
    if not k or not k["launches"] or not k.get("device_s") or not peak:
        return None
    return 100.0 * bound_bytes(k) / peak / k["device_s"]
