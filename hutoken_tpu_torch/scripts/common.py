"""What the port's drivers share: the ``--device`` switch, the card's
label, the committed fixture configurations and a device-side timer.

A driver runs on the card unless it is given ``--device cpu``.  Asked
for the card without one, it exits non-zero: it never falls back to
the CPU, and a CPU run prints no time under a device metric's name.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(_PKG)
FIXTURES = os.path.join(REPO, "tests", "fixtures")
# the committed configurations (bench.py:17-27); ``unique`` runs the
# ``small`` vocabulary on the high-entropy corpus
CONFIGS = ("small", "big-vocab", "big-merges")


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
    from ..profile_gather import card_label

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


def kernel_ms(fn) -> float:
    """Device ms per call of ``fn`` by CUDA events with a sleep queued
    ahead, so that the host's enqueue never paces the loop
    (``profile_gather.cuda_time``)."""
    from ..profile_gather import cuda_time

    return cuda_time(fn)


def launch_counts() -> dict:
    """The encode kernels' launch counters: narrow fused, wide fused,
    segmented.  Each wrapper adds one where it launches on the card."""
    from ..ops.fused_merge import merge_words_from_bytes_fused as fused
    from ..ops.seg_merge import seg_merge

    return {"fused_merge": fused.launches, "fused_merge_wide": fused.wide_launches,
            "seg_merge": seg_merge.launches}


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
