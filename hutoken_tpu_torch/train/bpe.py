"""String-keyed BPE training (reference: src/bpe.c).

The port's own copy of ``hutoken_tpu/train/bpe.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

The reference algorithm, restated array-style so it vectorizes:

* Seed the vocab with 256 single-byte tokens, ids 0-255 (bpe.c:243-250;
  byte 0 becomes the empty C string, preserved here as ``b""``).
* Split the corpus with the parser and lay down one element ("boundary")
  per byte — the parser covers every byte, so elements are simply all
  byte positions (bpe.c:50-106; the regex path is unreachable because the
  module-level ``pattern`` is never set, src/lib.c:70).
* Repeat: key every adjacent element pair by its *concatenated spelling*,
  pick the most frequent (first-to-reach tie-break), add it to the vocab
  with id ``count+1`` (bpe.c:171 — note the +1: id 256 is never assigned),
  and merge all its occurrences left-to-right.
* Stop when the vocab is full, fewer than two elements remain, or the
  same spelling wins twice in a row (bpe.c:117,124,221-224).

``strict=True`` (default) additionally reproduces two reference
implementation artifacts so token-for-token identical vocabularies come
out:

1. the per-round stats scan runs over the *original* element count, so
   stale tail entries left behind by earlier compactions keep being
   counted (bpe.c:130 uses ``token_num``, not ``token_n``);
2. the rewrite loop drops the final element whenever it is not part of a
   merge (bpe.c:184-210 never emits index ``token_n-1`` on the non-merge
   path).

``strict=False`` gives the corrected algorithm (the one the JAX
package's distributed trainer runs, where emulating array artifacts
would be pointless).
"""

from __future__ import annotations

import numpy as np

from ..pretokenize import split_words
from .common import MESH_MSG, count_pairs, first_to_reach_winner, left_to_right_merge_mask, save_vocab


def _seed_vocab() -> tuple[dict[bytes, int], int]:
    str2id: dict[bytes, int] = {}
    for i in range(256):
        key = b"" if i == 0 else bytes([i])
        str2id[key] = i
    return str2id, 256


def bpe_train_core(
    data: bytes,
    vocab_size: int,
    *,
    strict: bool = True,
    verbose: bool = True,
) -> dict[bytes, int]:
    """Run the merge loop; returns the vocab as token bytes -> id."""
    str2id, count = _seed_vocab()

    text = np.frombuffer(data, dtype=np.uint8)
    token_num = text.shape[0]
    # element i spans text[start[i] : end[i]+1]; csid interns the spelling
    start = np.arange(token_num, dtype=np.int64)
    end = np.arange(token_num, dtype=np.int64)
    csid = text.astype(np.int64)  # canonical string ids; 0-255 = single bytes
    csid_to_bytes: list[bytes] = [bytes([i]) for i in range(256)]
    bytes_to_csid: dict[bytes, int] = {bytes([i]): i for i in range(256)}
    # cache: (csid_l, csid_r) -> interned concat csid.  Keyed by the id
    # TUPLE, not the packed integer l*K+r: K grows between rounds, so a
    # packed key from one round can alias a different pair in another
    # (the reference has no such cache — its per-round stats map keys by
    # the pair STRING, bpe.c:130-165 — so aliasing would silently
    # corrupt group counts, as it did before round 4 fixed this)
    pair_string_cache: dict[tuple[int, int], int] = {}

    token_n = token_num
    prev_key: bytes | None = None

    while count < vocab_size:
        if token_n < 2:
            break
        scan_n = token_num if strict else token_n
        if scan_n < 2:
            break
        K = len(csid_to_bytes) + 1
        keys = csid[: scan_n - 1] * K + csid[1 : scan_n]
        uniq, inverse, counts = count_pairs(keys)

        # group unique (l,r) pairs by concatenated spelling
        group_of_pair = np.empty(uniq.shape[0], dtype=np.int64)
        for j, k in enumerate(uniq):
            k = int(k)
            lr = (k // K, k % K)
            g = pair_string_cache.get(lr)
            if g is None:
                s = csid_to_bytes[lr[0]] + csid_to_bytes[lr[1]]
                g = bytes_to_csid.get(s)
                if g is None:
                    g = len(csid_to_bytes)
                    csid_to_bytes.append(s)
                    bytes_to_csid[s] = g
                pair_string_cache[lr] = g
            group_of_pair[j] = g
        pos_groups = group_of_pair[inverse]
        num_groups = len(csid_to_bytes)
        group_counts = np.bincount(pos_groups, minlength=num_groups)
        win_g, _max_count = first_to_reach_winner(pos_groups, group_counts)
        win_bytes = csid_to_bytes[win_g]

        new_id = count + 1  # reference id-assignment quirk (bpe.c:171)
        if win_bytes not in str2id:
            count += 1  # hashmap count grows only on new keys
        str2id[win_bytes] = new_id

        # merge all occurrences over the live prefix
        live_pairs = pos_groups[: max(token_n - 1, 0)] == win_g
        take = left_to_right_merge_mask(live_pairs)
        take_idx = np.flatnonzero(take)
        consumed = np.zeros(token_n, dtype=bool)
        consumed[take_idx + 1] = True
        emit = ~consumed
        if strict and not (token_n >= 2 and take.size and take[token_n - 2]):
            # reference rewrite drops the unmerged final element
            emit[token_n - 1] = False
        new_end = end[:token_n].copy()
        new_end[take_idx] = end[take_idx + 1]
        new_csid = csid[:token_n].copy()
        new_csid[take_idx] = win_g
        j = int(emit.sum())
        start[:j] = start[:token_n][emit]
        end[:j] = new_end[emit]
        csid[:j] = new_csid[emit]
        token_n = j

        if verbose:
            print(
                f"Most common pair: '{win_bytes.decode('utf-8', 'replace')}',"
                f" rank: {_max_count}"
            )
            print(f"New token '{win_bytes.decode('utf-8', 'replace')}', value: {new_id}\n")

        if prev_key is not None and prev_key == win_bytes:
            break
        prev_key = win_bytes

    return str2id


def bpe_train(
    data: str,
    vocab_size: int,
    vocab_file_name: str,
    *,
    strict: bool = True,
    verbose: bool = True,
    mesh=None,
) -> str:
    """Train and save (reference: src/bpe.c:234-263, src/lib.c:76-100).
    ``mesh`` (multi-device training) is not ported and raises."""
    # split_words is called for parity with create_words; with the default
    # parser every byte lands in exactly one word, so elements == bytes.
    _ = split_words  # the parser covers all bytes; no element is dropped
    if mesh is not None:
        raise NotImplementedError(MESH_MSG)
    str2id = bpe_train_core(
        data.encode("utf-8"), vocab_size, strict=strict, verbose=verbose
    )
    return save_vocab(str2id, vocab_file_name)
