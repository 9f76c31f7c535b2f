"""The timed window: a closed loop of calls, and its arithmetic.

One caller sends calls back to back.  Call ``n`` takes batch ``n %
calls_per_pass`` of the pool.  A call starts while the clock is before
the deadline; the window closes when the last call that started returns,
so every call that ran is inside it, whole.  The rate is every byte of
every call over the window's seconds.

A call's outputs are dropped as soon as it returns, unless the check
keeps them, as a job drops a batch once it is written: outputs held
across the next call change how the allocator serves it.
"""

from __future__ import annotations

import random
import time
from dataclasses import dataclass, field


@dataclass
class Window:
    latencies: list = field(default_factory=list)  # seconds of each call, in order
    nbytes: int = 0  # UTF-8 bytes of every document of every call
    seconds: float = 0.0  # from the first call's start to the last call's return
    kept: dict = field(default_factory=dict)  # call ordinal -> (batch index, outputs)

    @property
    def calls(self) -> int:
        return len(self.latencies)


def rate_MBps(nbytes: int, seconds: float) -> float:
    """Bytes over seconds, in MB/s (1 MB = 10^6 bytes)."""
    return nbytes / 1e6 / seconds


class Reservoir:
    """A uniform sample of ``k`` calls from a stream of unknown length,
    drawn from ``seed`` (Algorithm R): call ``n`` (1-based among the
    candidates) replaces a random slot with probability ``k / n``."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = random.Random(seed)
        self.slots: list = []
        self.seen = 0

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.slots) < self.k:
            self.slots.append(item)
            return
        j = self.rng.randrange(self.seen)
        if j < self.k:
            self.slots[j] = item


def run_window(encode, batches, call_bytes, seconds: float, on_wrap=None,
               sample: int = 0, seed: int = 0, min_calls: int = 1,
               clock=time.perf_counter) -> Window:
    """Drive ``encode(batch)`` for ``seconds``, and for at least
    ``min_calls`` calls.

    ``on_wrap()`` runs before every pass but the first, inside the
    window and outside any call's time.  The outputs of the first call,
    of the last one and of ``sample`` calls drawn between them from
    ``seed`` are kept for the check, with the index of their batch.
    """
    w = Window()
    reservoir = Reservoir(sample, seed)
    lat = w.latencies
    n_batches = len(batches)
    nbytes = 0
    t0 = clock()
    deadline = t0 + seconds
    n = 0
    while True:
        k = n % n_batches
        if k == 0 and n and on_wrap is not None:
            on_wrap()
        ts = clock()
        out = encode(batches[k])
        te = clock()
        lat.append(te - ts)
        nbytes += call_bytes[k]
        n += 1
        final = te >= deadline and n >= min_calls
        if n == 1 or final:
            w.kept[n - 1] = (k, out)
        else:
            reservoir.offer((n - 1, k, out))
        out = None  # what the reservoir did not take is freed before the next call
        if final:
            break
    w.seconds = te - t0
    w.nbytes = nbytes
    for ordinal, k, out in reservoir.slots:
        w.kept[ordinal] = (k, out)
    return w
