"""The check that decides ``correct``.

After the window, the documents of the kept calls (the first, the last
and a sample drawn from the seed, see ``window.run_window``) are
compared, id for id, with the plain reference the configuration names
(``reference/bpe.py`` for both of today's), which reads the
configuration's files, takes its ``initialize`` options and encodes the
same documents itself.  In each kept call the check takes
``check_docs`` documents: the longest, and the rest drawn from the seed
(all of them when the call has no more).

Numbers compared, each with its limit:

* ``mismatched_docs``: documents whose ids differ from the reference's
  in any place or in length, and documents the call returned no answer
  for; limit 0, since ids are integers;
* ``failed_calls``: calls that raised; limit 0;
* ``docs_compared``: at least ``check_docs`` times the calls a run
  keeps (``check_calls``; the window runs at least that many calls), so
  that a run whose sample came out short cannot pass.
"""

from __future__ import annotations

import random


def pick_docs(batch: list, n: int, rng: random.Random) -> list[int]:
    """Indices of ``n`` documents of ``batch``: the longest, then a
    sample drawn from ``rng``, in order."""
    if len(batch) <= n:
        return list(range(len(batch)))
    longest = max(range(len(batch)), key=lambda i: len(batch[i]))
    rest = [i for i in range(len(batch)) if i != longest]
    return sorted([longest] + rng.sample(rest, n - 1))


def compare(kept: dict, batches: list, reference, check_docs: int, need: int,
            seed: int, failed_calls: int = 0) -> dict:
    """Compare the kept outputs with ``reference.encode``; returns the
    numbers compared, each with its value and limit, and ``correct``."""
    rng = random.Random(seed)
    mismatched = compared = tokens = 0
    for ordinal in sorted(kept):
        k, outs = kept[ordinal]
        batch = batches[k]
        for i in pick_docs(batch, check_docs, rng):
            compared += 1
            want = reference.encode(batch[i])
            tokens += len(want)
            got = outs[i] if outs is not None and len(outs) == len(batch) else None
            if got is None or list(got) != want:
                mismatched += 1
    numbers = {
        "mismatched_docs": {"value": mismatched, "limit": "<= 0"},
        "failed_calls": {"value": failed_calls, "limit": "<= 0"},
        "docs_compared": {"value": compared, "limit": f">= {need}"},
    }
    correct = mismatched == 0 and failed_calls == 0 and compared >= need
    return {"correct": correct, "numbers": numbers, "tokens_compared": tokens}


def lines(numbers: dict) -> list[str]:
    """One plain line per number compared, for the end of stderr."""
    return [f"check {name} {v['value']} {v['limit']}" for name, v in numbers.items()]
