"""One shared Python ``int`` for each id an engine can emit.

``TorchTokenizer.encode_batch`` hands out one Python list a document.
Built by ``ndarray.tolist()``, every item past 256 is a new ``int``
(CPython caches only -5 to 256): a 32-byte block a token, allocated
again on every call and freed one by one when the caller drops the
lists.  ``IdTable`` holds one ``int`` for each id instead, in an object
array, so that one gather over a call's ids (``take``) gives the
objects and each document's list only takes references to them.  The
values, their order and their type are those of ``tolist()``; only the
objects' identity differs.

Two layouts, chosen from the ids alone:

* dense, where the largest id is under ``DENSE_SPAN`` times the number
  of ids: slot ``i`` holds ``i`` for every ``i`` up to the largest id,
  holes included, and the last slot holds -1 (the id of an unknown
  character in char mode), which an index of -1 reads;
* sorted, past that span: the sorted ids and their objects, found by
  ``np.searchsorted``, so that a vocabulary with ids in the billions
  allocates nothing for its holes.

Published vocabularies have few holes (their largest id is within 1 %
of their id count), so they take the dense layout, whose gather is one
indexed load a token; a binary search costs about 15 compares a token
at 32,768 ids.  A span of 4 bounds the dense layout's cost at four
slots, 160 bytes with their ints, for each id of the vocabulary.

An id the table lacks (a vocabulary that grew after the table was
built) grows the table before the gather, so every id of the output is
a table object.
"""

from __future__ import annotations

import numpy as np

DENSE_SPAN = 4


class IdTable:
    """The shared ``int`` objects of ``ids`` and of -1."""

    def __init__(self, ids):
        self._layout(np.unique(np.append(np.asarray(list(ids), dtype=np.int64), -1)))

    def _layout(self, keys: np.ndarray) -> None:
        self.keys = keys
        top = int(keys[-1])
        self.dense = int(keys[0]) >= -1 and top + 2 <= DENSE_SPAN * len(keys)
        if self.dense:
            self.objs = np.append(np.arange(top + 1), -1).astype(object)
        else:
            self.objs = keys.astype(object)

    def take(self, ids: np.ndarray) -> np.ndarray:
        """The table's objects for ``ids`` (an integer array), as an
        object array of the same length."""
        if self.dense:
            if ids.size:
                top = len(self.objs) - 2
                lo, hi = int(ids.min()), int(ids.max())
                if lo < -1 or hi > top:
                    self._layout(np.union1d(self.keys, ids[(ids < -1) | (ids > top)]))
                    return self.take(ids)
            return self.objs.take(ids)
        pos = np.searchsorted(self.keys, ids)
        found = self.keys.take(np.minimum(pos, len(self.keys) - 1)) == ids
        if not found.all():
            self._layout(np.union1d(self.keys, ids[~found]))
            return self.take(ids)
        return self.objs.take(pos)
