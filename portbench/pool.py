"""The traffic pool of a run, made from ``--seed``.

A traffic file names its generator (``"generator": "module:function"``,
a function of ``portbench/gen/`` that takes the traffic's parameters and
a seed and returns the documents of one pass) and ``docs_per_call``.
The pool is that pass cut into calls of ``docs_per_call`` documents in
order, the last one shorter where they do not divide.
"""

from __future__ import annotations

from dataclasses import dataclass

from . import registry


@dataclass
class Pool:
    batches: list  # lists of documents, one a call
    call_bytes: list  # UTF-8 bytes of each batch

    @property
    def nbytes(self) -> int:
        return sum(self.call_bytes)


def seed_of(seed: int) -> int:
    """A non-negative seed for numpy and ``random`` from any integer."""
    return seed % (1 << 63)


def make_pool(traffic: dict, seed: int) -> Pool:
    docs = registry.named(traffic["generator"], "gen")(traffic, seed_of(seed))
    per_call = int(traffic["docs_per_call"])
    batches = [docs[i : i + per_call] for i in range(0, len(docs), per_call)]
    return Pool(batches, [sum(len(d.encode("utf-8")) for d in b) for b in batches])
