"""What the port's drivers share: the ``--device`` switch, the card's
label, the committed fixture configurations and the device-side timer
that every kernel time of the drivers, the smoke and the tools rests on
(:func:`cuda_time`).

A driver runs on the card unless it is given ``--device cpu``.  Asked
for the card without one, it exits non-zero: it never falls back to
the CPU, and a CPU run prints no time under a device metric's name.
"""

from __future__ import annotations

import argparse
import functools
import os
import subprocess
import sys
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
FIXTURES = os.path.join(REPO, "tests", "fixtures")
# the committed configurations (bench.py:17-27)
CONFIGS = ("small", "big-vocab", "big-merges")
REPS = 20  # timed calls of one cuda_time
L2_FLUSH_BYTES = 128 << 20  # read between cold calls: over twice the H100's 50 MB L2
LEAD_CYCLES = 1 << 25  # first length of the sleep that leads each timed loop
LEAD_DOUBLINGS = 4  # times the sleep may double before the timer gives up


def add_device_arg(parser: argparse.ArgumentParser) -> None:
    parser.add_argument(
        "--device", default="cuda", choices=("cuda", "cpu"),
        help="cuda (default): the card, or exit non-zero without one; "
        "cpu: the kernels' plain PyTorch twins, no device metric",
    )


def open_device(device: str) -> str:
    """The label a driver prints beside its numbers: the card's
    ``nvidia-smi`` name and power limit, or ``cpu``.  Exits with code 1
    when the card was asked for and CUDA is not available."""
    if device == "cpu":
        print("cpu: the kernels' plain twins; no time here is a device metric", flush=True)
        return "cpu"
    if not torch.cuda.is_available():
        sys.exit(f"{os.path.basename(sys.argv[0])}: no CUDA device "
                 "(torch.cuda.is_available() is False); pass --device cpu")
    label = card_label()
    print(label, flush=True)
    return label


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def wall(fn, device):
    """(result, seconds) of ``fn()`` on the host clock, ending in a
    synchronise on the card."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return out, time.perf_counter() - t0


def card_label() -> str:
    """The card's ``nvidia-smi`` name and power limit."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


@functools.lru_cache(maxsize=None)
def _l2_flush():
    """A call that reads ``L2_FLUSH_BYTES`` on the current device, which
    evicts whatever an earlier call left in its L2 and leaves it holding
    clean lines (a write would leave dirty ones, whose write-back would
    land in the next timed call)."""
    buf = torch.zeros(L2_FLUSH_BYTES // 4, dtype=torch.int32, device="cuda")
    return buf.sum


def cuda_time(fn, cold: bool = False) -> float:
    """Device ms per call of ``fn`` over ``REPS`` back-to-back calls, by
    CUDA events, after one warm call.  With ``cold``, L2 is flushed
    before each call and each call is timed between its own two events,
    the flush outside them: the time of a caller who finds the cache
    cold.

    A call at small shapes runs for a few microseconds on the card, less
    than the host takes to enqueue it, so events around a plain loop
    would time the host.  A sleep kernel queued first holds the stream
    while the host enqueues every call; the sleep is doubled until it
    outlasts the enqueue, and the timer raises if it never does rather
    than return a time the host paced."""
    flush = _l2_flush() if cold else None
    fn()
    torch.cuda.synchronize()
    for doubling in range(LEAD_DOUBLINGS + 1):
        lead, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
        marks = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                 for _ in range(REPS if cold else 0)]
        lead.record()
        torch.cuda._sleep(LEAD_CYCLES << doubling)
        start.record()
        t0 = time.perf_counter()
        if cold:
            for before, after in marks:
                flush()
                before.record()
                fn()
                after.record()
        else:
            for _ in range(REPS):
                fn()
        end.record()
        enqueue_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        lead_ms = lead.elapsed_time(start)
        if lead_ms > enqueue_ms:
            if cold:
                return sum(before.elapsed_time(after) for before, after in marks) / REPS
            return start.elapsed_time(end) / REPS
    raise RuntimeError(
        f"cuda_time: a {lead_ms:.3f} ms lead did not outlast the host's "
        f"{enqueue_ms:.3f} ms enqueue of {REPS} calls; the loop was host-paced"
    )


def launch_counts() -> dict:
    """The encode kernels' launch counters: narrow fused, wide fused,
    segmented, narrow id merge, wide id merge.  Each wrapper adds one
    where it launches on the card."""
    from ..ops.fused_merge import merge_words_from_bytes_fused as fused
    from ..ops.id_merge import id_merge
    from ..ops.seg_merge import seg_merge

    return {"fused_merge": fused.launches, "fused_merge_wide": fused.wide_launches,
            "seg_merge": seg_merge.launches, "id_merge": id_merge.launches,
            "id_merge_wide": id_merge.wide_launches}


def fixture_paths(name: str):
    """(vocab, special chars, merges or None) of a committed fixture:
    ``small`` (the 768-id byte-level vocabulary), ``big-vocab`` (23,096
    ids, string path) or ``big-merges`` (the same with merges.txt)."""
    if name not in CONFIGS:
        raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")
    stem = "bytelevel" if name == "small" else "bigvocab"
    vocab = os.path.join(FIXTURES, f"{stem}-vocab.txt")
    special = os.path.join(FIXTURES, f"{stem}-vocab_special_chars.txt")
    merges = os.path.join(FIXTURES, "bigvocab-merges.txt") if name == "big-merges" else None
    for p in (vocab, special, merges):
        if p is not None and not os.path.isfile(p):
            raise FileNotFoundError(f"fixture {p} is missing: run from a checkout of the repository")
    return vocab, special, merges


def load_ctx(name: str):
    """The ``TokenizerContext`` of a committed configuration."""
    from ..context import TokenizerContext

    vocab, special, merges = fixture_paths(name)
    return TokenizerContext.load(vocab, special, is_byte_encoder=True, merges_file_path=merges)


def top_device_ops(prof, n: int = 8):
    """(device self seconds, [(name, seconds, calls)] of the ``n``
    largest) of a ``torch.profiler`` run's CUDA events."""
    from torch.autograd import DeviceType

    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    total = sum(e.self_device_time_total for e in events) / 1e6
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:n]
    return total, [(e.key, e.self_device_time_total / 1e6, e.count) for e in top]
