"""Byte-level BPE training on id arrays (reference: src/bbpe.c).

The port's own copy of ``hutoken_tpu/train/bbpe.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Differences from the string trainer that matter for output parity:

* elements are token *ids*, seeded as raw byte values 0-255
  (bbpe.c:150-152), and pairs are keyed by id pair, not spelling;
* the new token id is ``vocab->count`` — no +1 (bbpe.c:87);
* training stops when the best pair's frequency is <= 1 (bbpe.c:83-84),
  when the vocab is full, or when the same id pair wins twice in a row
  (bbpe.c:111-115);
* the merge rewrite is a correct two-pointer compaction — no tail-drop
  (bbpe.c:53-71) — and counting runs over the live array only.

Tie-break: the reference's ``find_most_common_pair`` intends the same
first-to-reach-the-max rule as the string trainer.  (Its freq check reads
``pairs[-1]`` for newly inserted pairs — bbpe.c:35-47 leaves ``index`` at
-1 on the insert path — which is undefined behavior in C; we implement
the intended semantics: a fresh pair participates with count 1.)
"""

from __future__ import annotations

import numpy as np

from .common import MESH_MSG, count_pairs, first_to_reach_winner, left_to_right_merge_mask, save_vocab


def bbpe_train_core(
    data: bytes,
    vocab_size: int,
    *,
    verbose: bool = True,
    merge_log: list | None = None,
) -> dict[bytes, int]:
    """Run the merge loop; returns token bytes -> id.

    ``merge_log``, if given, collects ``(left_id, right_id, new_id)`` in
    training order (useful for emitting a merges.txt fixture).
    """
    str2id: dict[bytes, int] = {}
    id2str: dict[int, bytes] = {}
    for i in range(256):
        key = b"" if i == 0 else bytes([i])
        str2id[key] = i
        id2str[i] = key
    count = 256

    ids = np.frombuffer(data, dtype=np.uint8).astype(np.int64)
    token_n = ids.shape[0]
    prev_pair: tuple[int, int] | None = None

    while count < vocab_size:
        if token_n <= 1:
            break
        K = count + 1
        keys = ids[: token_n - 1] * K + ids[1:token_n]
        uniq, inverse, counts = count_pairs(keys)
        win_idx, max_count = first_to_reach_winner(inverse, counts)
        if max_count <= 1:
            break
        win_key = int(uniq[win_idx])
        id1, id2 = win_key // K, win_key % K

        new_id = count  # no +1 here (bbpe.c:87)
        merged = id2str.get(id1, b"") + id2str.get(id2, b"")
        if merged not in str2id:
            count += 1
        str2id[merged] = new_id
        id2str[new_id] = merged
        if merge_log is not None:
            merge_log.append((id1, id2, new_id))

        mask = inverse == win_idx
        take = left_to_right_merge_mask(mask)
        take_idx = np.flatnonzero(take)
        consumed = np.zeros(token_n, dtype=bool)
        consumed[take_idx + 1] = True
        new_ids = ids[:token_n].copy()
        new_ids[take_idx] = new_id
        kept = new_ids[~consumed]
        ids[: kept.shape[0]] = kept
        token_n = kept.shape[0]

        if verbose:
            print(f"Most common pair: ({id1}, {id2}), freq: {max_count}")
            print(f"New token id: {new_id}\n")

        if prev_pair == (id1, id2):
            break
        prev_pair = (id1, id2)

    return str2id


def bbpe_train(
    data: str,
    vocab_size: int,
    vocab_file_name: str,
    *,
    verbose: bool = True,
    mesh=None,
) -> str:
    """Train and save (reference: src/bbpe.c:126-160, src/lib.c:102-126).
    ``mesh`` (multi-device training) is not ported and raises."""
    if mesh is not None:
        raise NotImplementedError(MESH_MSG)
    str2id = bbpe_train_core(data.encode("utf-8"), vocab_size, verbose=verbose)
    return save_vocab(str2id, vocab_file_name)
