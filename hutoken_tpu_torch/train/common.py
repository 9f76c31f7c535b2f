"""Shared training machinery: pair counting with the reference tie-break.

The port's own copy of ``hutoken_tpu/train/common.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

The reference trainers pick the "most common pair" with a running
strictly-greater comparison during a left-to-right scan
(reference: src/bpe.c:130-165, src/bbpe.c:21-51): the winner is the pair
with the maximal final count; among ties, the one whose count *reached*
the maximum first, i.e. whose last occurrence in the scan comes earliest.
"""

from __future__ import annotations

import os

import numpy as np

MESH_MSG = (
    "mesh= (multi-device training) is not ported to PyTorch yet: "
    "ROADMAP queue 1 item 8"
)


def count_pairs(keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Unique pair keys with counts and per-position inverse."""
    uniq, inverse, counts = np.unique(keys, return_inverse=True, return_counts=True)
    return uniq, inverse, counts


def first_to_reach_winner(
    inverse: np.ndarray, group_counts: np.ndarray
) -> tuple[int, int]:
    """(winning group index, max count) under the reference tie-break.

    ``inverse`` maps scan position -> group; ``group_counts`` holds each
    group's total.  Winner = among groups with the max total, the group
    whose LAST occurrence has the smallest scan index (equivalently, the
    first group to accumulate the max count during the scan).
    """
    max_count = int(group_counts.max())
    candidates = np.flatnonzero(group_counts == max_count)
    if candidates.size == 1:
        return int(candidates[0]), max_count
    # last occurrence index per group
    n = inverse.shape[0]
    last_occ = np.full(group_counts.shape[0], -1, dtype=np.int64)
    # scatter positions; later positions overwrite earlier ones
    last_occ[inverse] = np.arange(n, dtype=np.int64)
    cand_last = last_occ[candidates]
    return int(candidates[np.argmin(cand_last)]), max_count


def left_to_right_merge_mask(mask: np.ndarray) -> np.ndarray:
    """Positions where a left-to-right scan-with-skip would merge.

    Reproduces the sequential "merge then skip the consumed element" loop
    (src/bpe.c:184-210, src/bbpe.c:53-71): within each run of consecutive
    True pair-positions, every even offset merges.
    """
    n = mask.shape[0]
    if n == 0:
        return mask
    idx = np.arange(n, dtype=np.int64)
    prev = np.concatenate(([False], mask[:-1]))
    run_start = mask & ~prev
    start_idx = np.where(run_start, idx, -1)
    start_idx = np.maximum.accumulate(start_idx)
    pos_in_run = idx - start_idx
    return mask & ((pos_in_run & 1) == 0)


def save_checkpoint(str2id: dict[bytes, int], path: str) -> None:
    """Write an intermediate vocab snapshot (same hex format as the final
    artifact, atomically).  The reference never checkpoints — its only
    artifact is the final save (src/helper.c:130-191); incremental
    checkpoints make long training runs resumable."""
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        for token, value in sorted(str2id.items(), key=lambda kv: (kv[1], kv[0])):
            if not token:
                f.write("0x00")
            else:
                f.write("".join(f"0x{b:02X}" for b in token))
            f.write(f" == {value}\n")
    os.replace(tmp, path)


def load_checkpoint(path: str) -> dict[bytes, int]:
    """Reload a checkpoint into trainer state (token bytes -> id)."""
    from ..formats import parse_vocab_file

    vocab = parse_vocab_file(path)
    out = {}
    for token, idx in vocab.str2id.items():
        out[token if token != b"" else b""] = idx
    return out


def save_vocab(str2id: dict[bytes, int], file_name: str) -> str:
    """Write the trained vocab to ``$HOME/config/<file_name>`` in hex format
    (reference: src/helper.c:130-191).

    Every surviving hashmap entry is written (the reference iterates the
    map, so an id overwritten by a duplicate-spelling merge can appear on
    two lines); we order by (id, spelling) instead of bucket order.
    """
    home = os.environ.get("HOME")
    if home is None:
        raise RuntimeError("Unable to get HOME environment variable.")
    dir_path = os.path.join(home, "config")
    os.makedirs(dir_path, exist_ok=True)
    file_path = os.path.join(dir_path, file_name)
    with open(file_path, "w", encoding="utf-8") as f:
        for token, value in sorted(str2id.items(), key=lambda kv: (kv[1], kv[0])):
            if not token:
                f.write("0x00")
            else:
                f.write("".join(f"0x{b:02X}" for b in token))
            f.write(f" == {value}\n")
    print(f"Vocab saved to: {file_path}")
    return file_path
