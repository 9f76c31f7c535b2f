#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

It imports nothing of JAX and nothing of the JAX package ``hutoken_tpu``
(the benchmark corpora and the generated wide vocabulary come from the
port's ``hutoken_tpu_torch/corpora.py``; the other fixtures are the
committed files), and checks at its end that neither was loaded.  Phases, each failing the run on its
own:

1. device: the card's name and power limit, torch and CUDA versions,
   and whether the native host library loaded;
2. build: compiles the four kernel sources of ``hutoken_tpu_torch/csrc``
   (one ``nvcc`` each, started together);
3. kernel vs plain, on the same CUDA tensors, exact equality on the
   prefix the host reads: the fused merge, which writes the packed
   layout, against ``compact_output`` of its plain twin for the small,
   big-vocab and big-merges tables at widths 8, 16 and 32 (rows of
   length 0 and 1 among long rows), each width timed on 16,384 corpus
   words beside
   ``compact_output`` alone on the same block (what the padded kernel of
   earlier versions needed after it); the segmented merge on mixed
   chunks (ASCII, Hungarian accents, words of 1-32 and over 32 bytes,
   document resets) and on a chunk of Zipf-corpus words whose every
   32-word run holds every length 0-32 with an 8-byte word that merges
   for more rounds than the other short words, timed on one raw-path
   chunk (4 MB) of the unique corpus.  Each kernel's bound counts the bytes it must move, the pair
   table's slots as the plain run probes them;
4. gather probe: ``hutoken_tpu_torch.scripts.profile_gather`` at every shape of
   the three TPU gather-profiling scripts and at its edge shapes (ragged
   counts, views at a 4-byte offset, ``gather_two_level`` on 2^22
   indices into tables in and past L2, ``gather_rows`` on rows of 5 and 33 indices, ``gather_cols``
   tables of 4,096 rows, at the slab route's crossover and one row past
   it, of 6,144, 14,000 and 16,384 rows and of width 100), each gather
   kernel equal to its twin (tolerance 0) and each ``gather_cols`` shape
   on its route (the slab up to ``SLAB_MAX_ROWS`` table rows, else L2);
   an empty launch's time, kernel, twin and one-PyTorch-call times,
   ``gather_cols`` / ``torch.gather`` at every ``cols`` shape, and the
   kernel's time under a cold L2, against which its bound and its
   32-byte-sector bound are read (no check fails on a time);
5. main path: the facade's ``initialize`` + ``batch_encode`` on the
   committed 23,096-id fixture (merges.txt and string-path configs)
   over a 24 MB Zipf corpus and an 8 MB high-entropy corpus.  Under
   ``HUTOKEN_TPU_RAW=auto`` the unique runs must take the raw path
   (segmented kernel launched, nearly every byte on the device) and the
   Zipf runs the word pipeline (fused kernel launched); big-merges /
   unique runs once more with ``HUTOKEN_TPU_RAW=0``.  Every document
   must equal the port's native host engine, a sample the port's scalar
   oracle; a cold run's MB/s and the share of corpus bytes sent to the
   device print beside the card's name and power limit; a sample
   round-trips through ``batch_decode``;
6. device decode: the facade with ``backend="device"`` decodes the ids
   of both corpora under both configs; every document must equal the
   native decode and the original text, the device path must have run,
   and decode MB/s prints beside the native host decode's; the engine's
   ``decode_arrays_device`` must return a CUDA blob equal byte for byte
   to the native ``decode_arrays``;
6w. a generated 100,256-id vocabulary (``corpora.write_wide_fixture``,
   string and merges paths, written to a temporary directory): the wide
   fused kernel against its twin as in phase 3, on Zipf corpus words
   (which must give ids of 0x10000 or more); then one facade
   ``initialize`` (``backend="device"``) per configuration;
   ``batch_encode`` of both corpora under ``HUTOKEN_TPU_RAW=auto`` must
   take the word pipeline with the wide kernel (never the raw path) and
   equal the native engine on every document and the oracle on a
   sample; then device decode of the same ids as in phase 6;
7. profile: one more cold run of big-merges / unique on each encode path
   under ``torch.profiler``: the device busy share, the top kernels, no
   ``compact_output`` span on the word pipeline, and the run's wall
   through ``encode_batch_arrays``;
8. device training (``hutoken_tpu_torch/parallel``, no hand kernel, so
   no entry in the kernels line), each against the port's host
   ``bbpe_train_core``: (a) 1 MB and 1,000 merges on ``data_mesh()``,
   vocab and merge log equal; (b) ``scripts/benchmark_train.py``'s
   BASELINE, 4 MB and 5,000 merges, warmed on another corpus outside the
   timed window: merges/s, its first 32 merges equal, and the step's
   device time under ``torch.profiler``, sort kernels against the rest,
   at the start and the end of training; (c) four shards on the card
   (``data_mesh(4)``) on 256 KB and 300 merges, dense and candidate
   picks, equal; (d) checkpoint every 8 merges to 280, resume to 300,
   equal to a straight run, on one and four shards; (e) one 32-merge
   chunk of each path under ``torch.cuda.set_sync_debug_mode("error")``;
9. device string training (``bpe_train(..., mesh=)``'s spelling-group
   trainer, no hand kernel), each against the port's host
   ``bpe_train_core(strict=False)``, whose merge log is read off the
   vocab it fills: warmed by 200 merges on another corpus; (a)
   ``scripts/benchmark_train.py --mode string``'s config, 1 MB and 1,000
   merges on ``data_mesh()``, vocab and merge log equal, timed; (b) the
   BASELINE's 4 MB to the first STRING_FULL_MERGES (1,000) of its 5,000
   merges, timed, its first 32 merges equal,
   then (a) once more under ``torch.profiler`` windows over four scan
   chunks and 32 tail-loop merges (device time against wall, busy
   share, top ops); each timed run prints merges/s,
   ``STRING_SCAN_STATS`` and whether the tail loop took over; (e) one
   16-sub-step chunk under ``set_sync_debug_mode("error")`` on one and
   four shards; (c) four shards on the card with the candidate tables
   cut to 16 rows a shard, equal, the deep pick run at least once; (d)
   checkpoint every 8 merges to 280, resume to 300, equal to a straight
   run, on one and four shards.  Each sub-phase prints its time;
10. sharded encode and training across processes (``parallel/sharded.py``,
   ``multihost.py``; the fused kernel per shard, no new kernel): (a)
   ``TorchTokenizer(ctx, mesh=data_mesh(4))`` on big-merges over both
   corpora and wide-merges over the unique one, cold runs in turns with
   the single-device engine (single, sharded, sharded, single; the
   single-device runs under ``HUTOKEN_TPU_RAW=0``, the same word
   pipeline), every document equal, MB/s of each, the fused kernel
   (narrow or wide) launched on every shard as often as the engine sent
   it blocks and ``seg_merge`` never, the device busy share of one
   profiled sharded run; again on ``data_mesh()`` with two or more
   cards; (b) a 1-process NCCL world in this process
   (``initialize_distributed`` twice, ``global_data_mesh()``) training
   both trainers at (c)'s 256 KB / 300 merges, equal to the host cores;
   (c) two processes over gloo (``python3 chip_smoke.py --peer ...``),
   two shards each on the card, equal to the host cores on both ranks;
   (d) two NCCL processes, one per card, with two or more cards, else a
   line saying it was not run.  Each sub-phase prints its time;
11. the 16-bit repair on the card: two 258-line vocabularies with ids
   past 0xFFFF (ids 70,000 / 70,001; a byte seed at 70,002 whose 16-bit
   key is that of a real rule), each on the wide table with 32-bit
   output: the wide fused kernel against its twin at widths 8, 16 and
   32, and the engine under ``HUTOKEN_TPU_RAW=0`` and ``=1`` equal to
   the native engine on every document (``encode_batch`` and
   ``encode_batch_arrays``), the wide kernel launched and no other;
   then the port's drivers, called in this process, the launch counts
   zeroed before each and read after it (no new kernel): ``entry.main``:
   ``entry()``'s fn on the card equal to ``compact_output`` of the fused
   twin on the read prefix, the fused kernel launched, then
   ``dryrun_multichip(4)`` on ``data_mesh(4)``; ``benchmark_train`` at
   1 MB / 1,000 merges; ``benchmark_sharded`` over ``data_mesh(1)``,
   ``(2)``, ``(4)``; ``profile_merge`` (the fused kernel at widths 8,
   16, 32, the id merge kernel against its eager twin on 1,024 x 128
   blocks, narrow and wide, and on a 16,384 x 32 char-mode block);
   ``profile_raw --mode both`` on 8 MB with the raw path's host stages,
   ``seg_merge`` launched.  Each prints its lines and its time.  End to
   end, encode is measured by the benchmark (``portbench/``) alone;
12. char mode and long words through the id merge kernel
   (``ops/id_merge.py``, ``csrc/id_merge.cu``): (a) the generated
   32,000-id char-mode vocabulary (``corpora.write_char_fixture``);
   (b) the facade on it (``is_byte_encoder=False``, no prefix: the
   pipelined core) over the Zipf and the unique corpus, then with
   ``prefix="▁"`` (the Python core) over a 2 MB slice of the Zipf one;
   (c) byte mode under ``HUTOKEN_TPU_RAW=0`` on Zipf documents each with
   eight 33-128-byte compounds of Zipf words, on big-merges (narrow) and
   the 100,256-id wide-merges table.  Every document equal to the
   native engine, a sample of 40 to the oracle; the id kernel (narrow or
   wide, and in (c) the fused kernel) launched, the eager fixed point
   never called, cold MB/s printed; (d) the kernel against its twin,
   exactly, at the engine's shapes: 16,384 x 32 char-mode ids of corpus
   words, 1,024 x 128 compound bytes on both tables, 1,024 x 128 ids on
   hand-built wide rules ranked from 2^24 with each row's first minimum
   at a position of 32 or more (``corpora.high_rank_rules``), and
   1,024 x 128 pad rows, each one launch with no host sync, timed back
   to back and under a cold L2 beside its twin, the twin's rounds (ms a
   round) and its bound; then the edge blocks of
   ``profile_merge.edge_block`` (the first merge at p = 0 and at the
   last pair, PAD inside and at both ends, one id or one pair repeated
   over the row, rows that merge to one id) on the char, big-merges,
   wide-merges and high-rank rules at widths 31, 32, 33, 63, 64, 65,
   127 and 128, each exact, one launch, no host sync, timed warm and
   cold beside its rounds.

The last two lines are the kernel summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from hutoken_tpu_torch.corpora import (  # noqa: E402
    build_corpus,
    build_unique_corpus,
    write_char_fixture,
    write_wide_fixture,
)
from hutoken_tpu_torch.scripts.common import card_label, cuda_time, fixture_paths, launch_counts, sync  # noqa: E402

ZIPF_MB = 24
UNIQUE_MB = 8
RAW_CHUNK = 1 << 22  # bytes of a raw-path chunk, HUTOKEN_TPU_RAW_C's default
BLOCK_WORDS = 16384  # ROW_BLOCKS[32] of the port's engine
CHECK_WORDS = 12345  # odd on purpose: the kernel takes any word count
ORACLE_SAMPLE = 40
MIXED_WORDS = 40000  # words per mixed check chunk
LENGTH_RUNS = 2000  # 32-word runs in the every-length chunk
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FIXTURES = os.path.join(HERE, "tests", "fixtures")
# phase 8: scripts/benchmark_train.py's BASELINE (4 MB, 5,000 merges) and
# a 1 MB, 1,000-merge run held to the host core merge for merge
EXACT_MB, EXACT_MERGES = 1.0, 1000
FULL_MB, FULL_MERGES = 4.0, 5000
WARM_MERGES = 256
PREFIX_MERGES = 32
SHARDS, SHARD_MB, SHARD_MERGES = 4, 0.256, 300
SCAN_STEPS = 32  # the trainer's merges per chunk
PROFILE_CHUNKS = 4
# phase 9: the string trainer at scripts/benchmark_train.py --mode
# string's config (1 MB, 1,000 merges, seed 0) and at the BASELINE; the
# four-shard runs cut the candidate tables to STRING_DEPTH rows a shard
STRING_MERGES = 1000
# the BASELINE's 4 MB is trained to this prefix of its 5,000 merges
STRING_FULL_MERGES = 1000
STRING_WARM_MERGES = 200
STRING_DEPTH = 16
STRING_SHARD_MERGES = 300
STRING_PROFILE_CHUNKS = 4
STRING_PROFILE_TAIL = 32
# phase 10: the sharded engine's shards on one card, and the time a
# multi-process sub-phase may take
MESH_SHARDS = 4
PEER_TIMEOUT = 300
# phase 11: the 16-bit repair's vocabularies get enough distinct words
# for two full blocks of each bucket (ROW_BLOCKS 16,384 / 1,024)
HOLE_WORDS, HOLE_LONG_WORDS = 40000, 2500
# phase 12: the slice encoded with the "▁" prefix (the Python core), the
# long-word documents (Zipf documents, each with LONG_PER_DOC compounds
# of 33-128 bytes), and the id kernel's block shapes in the engine
# (ROW_BLOCKS)
CHAR_PREFIX_MB = 2.0
LONG_DOCS, LONG_PER_DOC = 2000, 8
ID_BLOCKS = ((16384, 32), (1024, 128))

# ------------------------------------------------------------- inputs


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def wide_paths(directory: str) -> dict:
    """Write the generated 100,256-id vocabulary into ``directory``;
    returns config name -> (vocab, special chars, merges or None)."""
    vocab, special, merges = write_wide_fixture(directory)
    return {"wide-string": (vocab, special, None), "wide-merges": (vocab, special, merges)}


def load_config(paths):
    """(TokenizerContext, EncoderTables) of (vocab, special, merges)."""
    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.tables import build_encoder_tables

    vocab, special, merges = paths
    ctx = TokenizerContext.load(vocab, special, is_byte_encoder=True, merges_file_path=merges)
    return ctx, build_encoder_tables(ctx)


def random_block(rng, n: int, width: int):
    """ASCII and high bytes, lengths 0..width, a fifth of the rows of
    length 0 and a fifth of length 1."""
    alphabet = np.frombuffer(HIGH_BYTES, dtype=np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    lens[rng.random(n) < 0.2] = 0
    lens[rng.random(n) < 0.2] = 1
    raw = alphabet[rng.integers(0, len(alphabet), (n, width))]
    ascii_rows = rng.random(n) < 0.5
    raw[ascii_rows] = rng.integers(ord("a"), ord("z") + 1, (int(ascii_rows.sum()), width))
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    return raw, lens


def corpus_words(docs: list[str], lo: int, hi: int) -> list[bytes]:
    """Distinct words of lo..hi bytes of the first documents, with the
    leading space the split keeps."""
    seen = set()
    for d in docs[:4000]:
        for w in d.split(" "):
            b = (" " + w).encode()
            if lo <= len(b) <= hi:
                seen.add(b)
    return sorted(seen)


def corpus_block(docs: list[str], rng, n: int, width: int):
    """``n`` corpus words of 2..width bytes, length-sorted as the engine
    packs them."""
    words = corpus_words(docs, 2, width)
    pick = sorted((words[i] for i in rng.choice(len(words), n, replace=len(words) < n)), key=len)
    raw = np.zeros((n, width), dtype=np.uint8)
    lens = np.array([len(w) for w in pick], dtype=np.int32)
    for i, w in enumerate(pick):
        raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    return raw, lens


# ------------------------------------------------------------- timing


def time_ms(fn, reps: int) -> float:
    """Ms per call by events around a loop: for calls that wait on the
    host anyway (the plain twins sync every round)."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


@contextlib.contextmanager
def probe_log():
    """Record every (left, right) pair the plain twins probe (the fused
    twin's rounds and ``merge_fixed_point``)."""
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import merge as TM

    pairs = []
    real = FM.probe_pairs

    def logged(tab, a, b):
        pairs.append((a.reshape(-1), b.reshape(-1)))
        return real(tab, a, b)

    FM.probe_pairs = TM.probe_pairs = logged
    try:
        yield pairs
    finally:
        FM.probe_pairs = TM.probe_pairs = real


def probed_slot_bytes(tab, pairs, with_minsuper: bool = True) -> int:
    """Pair-table bytes that the merge must read for these pairs, counted
    over the distinct slots the probe visits (from the hash slot up to
    the hit or the first empty slot).  Narrow table: a 4-byte key per
    visited slot, a 4-byte value per hit slot and, with a minsuper bound,
    4 bytes per distinct hit rank; the kernel's 16-byte interleaved slot
    is its own choice, not the function's need.  Wide table: a whole
    16-byte slot per visited slot, since its key is both 32-bit ids.
    ``with_minsuper`` False: a merge that never reads the bound."""
    import torch

    from hutoken_tpu_torch.ops.merge import hash_slots, pack_key

    touched = torch.zeros(tab.cap_mask + 1, dtype=torch.bool, device=tab.device)
    hits = torch.zeros_like(touched)
    for a, b in pairs:
        real = (a >= 0) & (b >= 0)
        a, b = a[real], b[real]
        h = hash_slots(a, b, tab.cap_mask)
        alive = torch.ones_like(a, dtype=torch.bool)
        key = None if tab.wide else pack_key(a, b)
        for i in range(tab.probe_len):
            slot = (h + i) & tab.cap_mask
            touched[slot[alive]] = True
            if tab.wide:
                s = tab.slots[slot]
                hit, empty = (s[:, 0] == a) & (s[:, 1] == b), s[:, 0] == -1
            else:
                k = tab.pslots[slot, 0]
                hit, empty = k == key, k == -1
            hits[slot[alive & hit]] = True
            alive &= ~(hit | empty)
    if tab.wide:
        return 16 * int(touched.sum())
    nbytes = 4 * int(touched.sum()) + 4 * int(hits.sum())
    if tab.minsuper is not None and with_minsuper:
        ranks = (tab.pslots[hits, 1] >> 16) & 0xFFFF
        nbytes += 4 * int(torch.unique(ranks).numel())
    return nbytes


def bound_entry(nbytes: int) -> dict:
    return {"bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}


# ------------------------------------------------------------- phase 3


def fused_vs_plain(device: str, docs: list[str], label: str, configs: dict) -> dict:
    """Phase 3: the packed kernel == ``compact_output`` of the twin on
    the card for each of ``configs`` (name -> paths; all narrow or all
    wide, the variant each launches), on the prefix the host reads, at
    widths 8, 16 and 32; then each width timed on corpus words, with
    the twin and ``compact_output`` alone beside it.
    A wide table's corpus words must give ids of 0x10000 or more."""
    import torch

    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops.merge import compact_output
    from hutoken_tpu_torch.tables import device_tables, max_token_id

    rng = np.random.default_rng(0)
    result = {"max_abs_err": 0, "by": {}}
    for name, paths in configs.items():
        ctx, enc = load_config(paths)
        tab = device_tables(enc, ctx, device)
        u16 = max_token_id(ctx.vocab) < 0xFFFF  # the engine's rule
        check(tab.wide == name.startswith("wide-"), f"{name}: the table's layout")
        for width in (8, 16, 32):
            raw, lens = random_block(rng, CHECK_WORDS, width)
            r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
            want = compact_output(FM.fused_merge_plain(tab, r, n)[0], u16)
            read = CHECK_WORDS + int(want[:CHECK_WORDS].to(torch.int64).sum())
            got = FM.merge_words_from_bytes_fused(tab, r, n, u16)
            err = int((got[:read].to(torch.int64) - want[:read].to(torch.int64)).abs().max())
            result["max_abs_err"] = max(result["max_abs_err"], err)
            check(err == 0, f"packed kernel == packed twin ({name}, L={width})")
            print(f"kernel vs plain  {name:11s} W={CHECK_WORDS} L={width}: packed prefix of "
                  f"{read} entries equal (max_abs_err 0, tolerance 0); "
                  f"words merged {int((want[:CHECK_WORDS].to(torch.int32) < n).sum())}")
        for width in (8, 16, 32):
            raw, lens = corpus_block(docs, rng, BLOCK_WORDS, width)
            r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
            with probe_log() as pairs:
                ids, counts = FM.fused_merge_plain(tab, r, n)
            want = compact_output(ids, u16)
            read = BLOCK_WORDS + int(counts.sum())
            got = FM.merge_words_from_bytes_fused(tab, r, n, u16)
            check(torch.equal(got[:read], want[:read]), f"kernel == twin on corpus words ({name}, L={width})")
            if tab.wide and width == 32:
                check(int(ids.max()) >= 0x10000, f"{name}: corpus words give ids of 0x10000 or more")
            scan_bytes = 8 * (1 + -(-BLOCK_WORDS // (FM.WARPS_PER_BLOCK * 32 // FM.tile_width(width))))
            nbytes = (raw.nbytes + lens.nbytes + 1024 + probed_slot_bytes(tab, pairs)
                      + read * want.element_size() + scan_bytes)
            # in turns, inside this call; the pair table is meant to stay
            # in L2, so launches are not separated by a cache flush
            p1 = time_ms(lambda: compact_output(FM.fused_merge_plain(tab, r, n)[0], u16), 2)
            k1 = cuda_time(lambda: FM.merge_words_from_bytes_fused(tab, r, n, u16))
            c1 = time_ms(lambda: compact_output(ids, u16), 10)
            k2 = cuda_time(lambda: FM.merge_words_from_bytes_fused(tab, r, n, u16))
            row = {"ms": (k1 + k2) / 2, "plain_ms": p1, "compact_output_ms": c1,
                   **bound_entry(nbytes)}
            result["by"][f"{name} L={width}"] = row
            print(f"[{label}] fused merge {name:11s} {BLOCK_WORDS}x{width} corpus words: "
                  f"kernel {k1:.4f} / {k2:.4f} ms; twin + compact_output {p1:.3f} ms; "
                  f"compact_output alone {c1:.4f} ms; bound {row['bound_ms']:.5f} ms "
                  f"({nbytes} B), share {row['bound_ms'] / row['ms']:.3f}")
    return result


def mixed_chunk(rng, n_words: int):
    """(chunk bytes, document ends) of random documents: ASCII letters,
    digits and punctuation, Hungarian accented letters (0xC3/0xC5
    pairs), words of 1-32 and some of 33-60 characters, assorted
    whitespace."""
    letters = list("abcdefghijklmnopqrstuvwxyzABCXYZ" + "áéíóöőúüűÁÉŐŰ")
    other = list("0123456789.,!?-")
    spaces = [" ", " ", " ", "  ", "\n", "\t", " \n"]
    lens = np.where(rng.random(n_words) < 0.02,
                    rng.integers(33, 61, n_words), rng.integers(1, 33, n_words))
    pool = rng.choice(letters, int(lens.sum()))
    digits = rng.choice(other, int(lens.sum()))
    use_other = rng.random(n_words) < 0.15
    docs, words, off = [], [], 0
    for i, ln in enumerate(lens.tolist()):
        src = digits if use_other[i] else pool
        words.append("".join(src[off : off + ln]) + spaces[int(rng.integers(0, len(spaces)))])
        off += ln
        if rng.random() < 0.01:
            docs.append("".join(words))
            words = []
    docs.append("".join(words))
    blobs = [d.encode() for d in docs if d]
    return np.frombuffer(b"".join(blobs), dtype=np.uint8), np.cumsum([len(b) for b in blobs])


def seg_inputs(device: str, chunk: np.ndarray, ends: np.ndarray):
    """(chunk, word starts, word lengths) on the card from the port's own
    start mask, as the raw path lists them: longer words at length 0."""
    import torch

    from hutoken_tpu_torch.ops import split as S

    c = torch.from_numpy(chunk.copy()).to(device)
    e = torch.from_numpy(ends.astype(np.int32)).to(device)
    starts, lens = S.chunk_words(c, e)
    lens = torch.where(lens > S.MAX_WORD, 0, lens)
    return c, starts.to(torch.int32), lens.to(torch.int32)


def rounds_of(tab, word: bytes) -> int:
    """Merge rounds of one word in the plain twin (one probe a round,
    and a last one that merges nothing)."""
    import torch

    from hutoken_tpu_torch.ops import fused_merge as FM

    raw = torch.zeros((1, 32), dtype=torch.uint8, device=tab.device)
    raw[0, : len(word)] = torch.tensor(list(word), dtype=torch.uint8)
    with probe_log() as pairs:
        FM.fused_merge_plain(tab, raw, torch.tensor([len(word)], dtype=torch.int32, device=tab.device))
    return len(pairs) - 1


def length_chunk(device: str, tab, docs: list[str], rng):
    """A chunk of LENGTH_RUNS runs of 33 words listed in a random order
    per run, one of every length 0-32, so that each 32-word run of the
    list holds short words, long words and skips together.  Its 8-byte
    word is the corpus word that merges for the most rounds, and every
    shorter word one that merges for fewer: the 8-lane tiles of a run
    leave the loop in different rounds.  Returns (chunk, starts, lens)
    on the card and the rounds (8-byte word, most of the shorter)."""
    import torch

    pick = {}
    for ln in range(1, 33):
        words = corpus_words(docs, ln, ln) or [bytes(rng.integers(97, 123, ln).tolist())]
        if ln <= 8:
            sample = words[:: max(1, len(words) // 60)]
            rounds = [rounds_of(tab, w) for w in sample]
            best = int(np.argmax(rounds) if ln == 8 else np.argmin(rounds))
            pick[ln] = (sample[best], rounds[best])
        else:
            pick[ln] = (words[int(rng.integers(0, len(words)))], None)
    long_rounds = pick[8][1]
    short_rounds = max(r for ln, (_w, r) in pick.items() if ln < 8)
    blob, starts, lens = bytearray(), [], []
    for _ in range(LENGTH_RUNS):
        for ln in rng.permutation(33).tolist():
            starts.append(len(blob))
            lens.append(ln)
            if ln:
                blob += pick[ln][0]
    c = torch.from_numpy(np.frombuffer(bytes(blob), dtype=np.uint8).copy()).to(device)
    return (c, torch.tensor(starts, dtype=torch.int32, device=device),
            torch.tensor(lens, dtype=torch.int32, device=device)), (long_rounds, short_rounds)


def raw_chunk(docs: list[str]):
    """The corpus's first raw-path chunk: whole documents up to
    ``RAW_CHUNK`` bytes, as the engine's producer fills one; (bytes,
    document ends)."""
    blobs, size = [], 0
    for d in docs:
        b = d.encode()
        if size + len(b) > RAW_CHUNK:
            break
        blobs.append(b)
        size += len(b)
    return np.frombuffer(b"".join(blobs), dtype=np.uint8), np.cumsum([len(b) for b in blobs])


def seg_vs_plain(device: str, docs: list[str], words: list[str], label: str) -> dict:
    """Phase 3, segmented merge: kernel == twin on the card, the
    every-length chunk made of the words of ``words``; times on one
    raw-path chunk of ``docs``, the unique corpus."""
    import torch

    from hutoken_tpu_torch.ops import seg_merge as SM
    from hutoken_tpu_torch.ops import split as S
    from hutoken_tpu_torch.tables import device_tables

    rng = np.random.default_rng(2)
    result = {"max_abs_err": 0, "by": {}}
    big = raw_chunk(docs)
    for name in ("small", "big-vocab", "big-merges"):
        ctx, enc = load_config(fixture_paths(name))
        tab = device_tables(enc, ctx, device)
        chunk, ends = mixed_chunk(rng, MIXED_WORDS)
        check(S.supported_alphabet(chunk), "mixed chunk is in the device alphabet")
        lengths, (long_r, short_r) = length_chunk(device, tab, words, rng)
        check(long_r > short_r, f"{name}: the 8-byte word merges for more rounds ({long_r}) "
              f"than the shorter ones ({short_r})")
        for what, args in (("mixed", seg_inputs(device, chunk, ends)), ("every length", lengths)):
            want = SM.seg_merge_plain(tab, *args)
            err = int((SM.seg_merge(tab, *args) - want).abs().max())
            result["max_abs_err"] = max(result["max_abs_err"], err)
            check(err == 0, f"seg kernel == plain twin ({name}, {what})")
            print(f"seg kernel vs plain {name:10s} {what} chunk {args[0].shape[0]} B, "
                  f"{args[1].shape[0]} words: max_abs_err 0 (tolerance 0); "
                  f"tokens {int((want >= 0).sum())}"
                  + (f"; 8-byte word {long_r} rounds, shorter ones at most {short_r}"
                     if what == "every length" else ""))
        args = seg_inputs(device, *big)
        with probe_log() as pairs:
            want = SM.seg_merge_plain(tab, *args)
        check(torch.equal(SM.seg_merge(tab, *args), want), f"seg kernel == plain twin on a raw chunk ({name})")
        n = args[0].shape[0]
        nbytes = n + 8 * args[1].shape[0] + 1024 + probed_slot_bytes(tab, pairs) + 4 * n
        p1 = time_ms(lambda: SM.seg_merge_plain(tab, *args), 2)
        k1 = cuda_time(lambda: SM.seg_merge(tab, *args))
        k2 = cuda_time(lambda: SM.seg_merge(tab, *args))
        row = {"ms": (k1 + k2) / 2, "plain_ms": p1, **bound_entry(nbytes)}
        result["by"][name] = row
        print(f"[{label}] seg merge {name:10s} raw chunk {n} B, {args[1].shape[0]} words: "
              f"kernel {k1:.4f} / {k2:.4f} ms; twin {p1:.3f} ms; bound "
              f"{row['bound_ms']:.5f} ms ({nbytes} B), share {row['bound_ms'] / row['ms']:.3f}")
    return result


# ------------------------------------------------------- phases 4 to 7


def zero_launch_counts() -> None:
    """Every kernel's launch count, and the eager fixed point's calls."""
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import id_merge as IM
    from hutoken_tpu_torch.ops import merge as TM
    from hutoken_tpu_torch.ops import seg_merge as SM

    f = FM.merge_words_from_bytes_fused
    f.launches = f.wide_launches = SM.seg_merge.launches = 0
    IM.id_merge.launches = IM.id_merge.wide_launches = TM.merge_fixed_point.calls = 0


# the kernels an encode path must launch, and those it must not
PATHS = {
    "raw": (("seg_merge",), ()),
    "pipeline": (("fused_merge",), ("fused_merge_wide", "seg_merge")),
    "wide": (("fused_merge_wide",), ("fused_merge", "seg_merge")),
    "char": (("id_merge",), ("fused_merge", "fused_merge_wide", "seg_merge", "id_merge_wide")),
    "long": (("fused_merge", "id_merge"), ("fused_merge_wide", "seg_merge", "id_merge_wide")),
    "long-wide": (("fused_merge_wide", "id_merge_wide"), ("fused_merge", "seg_merge", "id_merge")),
}


def encode_run(native, docs: list[str], what: str, want_path: str, label: str):
    """One main-path run through the initialized facade: a checked run,
    then a timed cold one, the counts zeroed right before each and read
    right after.  ``want_path`` is the path it must take, a key of
    ``PATHS``: "raw" (the segmented kernel), "pipeline" (the fused
    kernel), "wide" (the wide fused kernel), "char" (the id kernel),
    "long" (the fused and the id kernel) or "long-wide" (both wide); the
    eager fixed point is never called.  ``native`` is the native engine
    of the same configuration.  Returns (ids per document, the cold run's
    launch counts, the largest id)."""
    import torch

    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch import oracle
    from hutoken_tpu_torch.ops.merge import merge_fixed_point

    engine = hutoken._get_engine()
    nbytes = sum(len(d.encode()) for d in docs)
    zero_launch_counts()
    got = hutoken.batch_encode(docs)
    first = launch_counts()
    want = native.encode_batch(docs, 8)
    bad = sum(g != w for g, w in zip(got, want))
    check(len(got) == len(docs) and bad == 0, f"{what}: {bad} documents differ from native")
    rng = np.random.default_rng(1)
    sample = [int(i) for i in rng.choice(len(docs), ORACLE_SAMPLE, replace=False)]
    check(all(got[i] == oracle.encode(hutoken._ctx, docs[i]) for i in sample), f"{what}: oracle")
    check(hutoken.batch_decode([got[i] for i in sample]) == [docs[i] for i in sample], "decode round trip")
    max_id = max(max(g) for g in got if g)

    engine.reset_cache()
    dev0 = engine.stat_device_bytes
    zero_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hutoken.batch_encode(docs)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    counts = launch_counts()
    eager = merge_fixed_point.calls
    check(counts == first, f"{what}: a cold run launches as the first run did ({counts} vs {first})")
    check(eager == 0, f"{what}: the eager fixed point ran {eager} times on the card")
    share = (engine.stat_device_bytes - dev0) / nbytes
    must, never = PATHS[want_path]
    check(all(counts[k] > 0 for k in must) and not any(counts[k] for k in never),
          f"{what}: the {want_path} path must launch {must} and none of {never}: {counts}")
    if want_path == "raw":
        check(share > 0.9, f"{what}: only {share:.4f} of the bytes reached the device")
        check(engine.stat_host_cause.get("raw_host_chunk", 0) == 0, f"{what}: a chunk went to the host")
    ctx = hutoken._ctx
    pipelined = engine._native_split_ok and ctx.prefix is None and ctx.compiled_pattern is None
    core = "raw" if want_path == "raw" else ("pipelined" if pipelined else "python")
    print(f"[{label}] main path {what}: {nbytes / 1e6:.1f} MB, "
          f"{len(docs)} docs: equal to native (all docs) and oracle ({ORACLE_SAMPLE}); "
          f"{core} core; cold run {nbytes / 1e6 / dt:.2f} MB/s ({dt:.3f} s); "
          f"device byte share {share:.4f}; launches per run fused {counts['fused_merge']}, "
          f"wide {counts['fused_merge_wide']}, seg {counts['seg_merge']}, id {counts['id_merge']}, "
          f"id wide {counts['id_merge_wide']}, eager fixed point calls {eager}; "
          f"max id {max_id}; host bytes by cause {engine.stat_host_cause}")
    return got, counts, max_id


def main_path(device: str, zipf: list[str], unique: list[str], label: str):
    """Phase 5 through the facade; returns each kernel's launches over
    all runs, and per run."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch.native import NativeEngine

    # (config, corpus name, docs, HUTOKEN_TPU_RAW, path it must take)
    runs = [
        ("big-merges", "zipf", zipf, "auto", "pipeline"),
        ("big-merges", "unique", unique, "auto", "raw"),
        ("big-merges", "unique", unique, "0", "pipeline"),
        ("big-vocab", "zipf", zipf, "auto", "pipeline"),
        ("big-vocab", "unique", unique, "auto", "raw"),
    ]
    launches = {k: 0 for k in launch_counts()}
    per_run = {k: {} for k in launches}
    for config, cname, docs, raw_env, want_path in runs:
        os.environ["HUTOKEN_TPU_RAW"] = raw_env
        vocab, special, merges = fixture_paths(config)
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=True, device=device, **kw)
        run = f"{config} {cname} RAW={raw_env}"
        _got, counts, _max_id = encode_run(NativeEngine(hutoken._ctx), docs,
                                           f"{config:10s} {cname:6s} RAW={raw_env:4s}", want_path, label)
        for k, v in counts.items():
            launches[k] += v
            if v:
                per_run[k][run] = v
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return launches, per_run


def wide_main_path(device: str, zipf: list[str], unique: list[str], label: str,
                   configs: dict):
    """Phase 6w: one facade per wide configuration, both corpora encoded
    under ``HUTOKEN_TPU_RAW=auto`` (the word pipeline with the wide
    kernel), then their ids decoded on the device; returns the wide
    kernel's launches, in all and per run."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch.native import NativeEngine

    launches, per_run = 0, {}
    os.environ["HUTOKEN_TPU_RAW"] = "auto"
    for config, (vocab, special, merges) in configs.items():
        t0 = time.perf_counter()
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=True, backend="device",
                           device=device, **kw)
        hutoken._get_engine()
        native = NativeEngine(hutoken._ctx)
        print(f"{config}: facade, engine and native engine built in {time.perf_counter() - t0:.1f} s")
        check(hutoken._get_engine().dev_tables.wide, f"{config}: the engine holds the wide table")
        max_ids = []
        for cname, docs in (("zipf", zipf), ("unique", unique)):
            ids, counts, max_id = encode_run(native, docs, f"{config:11s} {cname:6s} RAW=auto", "wide", label)
            launches += counts["fused_merge_wide"]
            per_run[f"{config} {cname} RAW=auto"] = counts["fused_merge_wide"]
            max_ids.append(max_id)
            decode_run(native, docs, ids, f"{config:11s} {cname:6s}", label)
        # the unique corpus's random identifiers stay below 0x10000 here
        check(max(max_ids) >= 0x10000, f"{config}: no id of 0x10000 or more")
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return launches, per_run


def gather_probe(device: str, label: str) -> list[dict]:
    """Phase 4: the gather probe at every shape of the three scripts, its
    kernels' counts zeroed right before and read right after.  Prints an
    empty launch's time and ``gather_cols`` / ``torch.gather`` at every
    ``cols`` shape, and checks which route each ``cols`` shape took.
    Returns one kernels-line entry per TPU kernel: the worst error over
    its shapes, the times at the largest shape of its Pallas loop, and the
    share of its bound from the time under a cold L2."""
    from hutoken_tpu_torch.ops import gather as G
    from hutoken_tpu_torch.scripts import profile_gather as PG

    empty_ms = PG.empty_launch_ms()
    print(f"[{label}] empty launch (torch.cuda._sleep(0)) {empty_ms:.4f} ms")
    G.reset_launches()
    rows = PG.run(device, timer=cuda_time, label=label)
    for r in rows:
        if r["probe"] != "cols":
            continue
        dims = dict(kv.split("=") for kv in r["case"].split())
        slab = (int(dims.get("K", G.LANES)) % 4 == 0 and not int(dims.get("off", 0))
                and int(dims["C"]) <= G.SLAB_MAX_ROWS)
        check(r["route"] == ("slab" if slab else "l2"),
              f"gather_cols {r['case']} took the {r['route']} route")
        print(f"[{label}] gather_cols {r['case']:20s} route {r['route']:4s}: "
              f"{r['ms']:.4f} ms / torch.gather {r['library_ms']:.4f} ms = "
              f"{r['ms'] / r['library_ms']:.3f}")
    entries = []
    for probe, (kernel, mode, replaces) in PG.KERNELS.items():
        launches = G.gather_1d.launches_by_mode[mode] if mode else getattr(G, kernel).launches
        check(launches > 0, f"the probe launched {kernel} ({probe})")
        mine = [r for r in rows if r["probe"] == probe]
        # the last of the largest shapes of its Pallas loop (largest table)
        main = max(reversed([r for r in mine if r["pallas"]]), key=lambda r: r["lookups"])
        entry = {
            "name": kernel,
            "route": "cuda",
            "source": "hutoken_tpu_torch/csrc/gather.cu",
            "replaces": replaces,
            "launches": launches,
            "launches_per_run": 0,  # the probe is no part of the main path
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"],
            "bound_by": "bytes",
            "sector_bound_ms": main["sector_bound_ms"],
            "library_ms": main["library_ms"],
            "cold_ms": main["cold_ms"],
            "share": main["bound_ms"] / main["cold_ms"],
            "empty_launch_ms": empty_ms,
            "shape": main["case"],
            "ms_by_shape": {r["case"]: r["ms"] for r in mine},
            "cold_ms_by_shape": {r["case"]: r["cold_ms"] for r in mine},
            "plain_ms_by_shape": {r["case"]: r["plain_ms"] for r in mine},
            "library_ms_by_shape": {r["case"]: r["library_ms"] for r in mine},
            "bound_ms_by_shape": {r["case"]: r["bound_ms"] for r in mine},
            "sector_bound_ms_by_shape": {r["case"]: r["sector_bound_ms"] for r in mine},
        }
        if mode:
            entry["variant"] = mode
        entries.append(entry)
    return entries


def device_decode(device: str, zipf: list[str], unique: list[str], label: str) -> None:
    """Phase 6: device decode through the facade (``backend="device"``)
    of both corpora's native ids under both committed configurations."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch.native import NativeEngine

    for config in ("big-merges", "big-vocab"):
        vocab, special, merges = fixture_paths(config)
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=True, backend="device",
                           device=device, **kw)
        native = NativeEngine(hutoken._ctx)
        for cname, docs in (("zipf", zipf), ("unique", unique)):
            decode_run(native, docs, native.encode_batch(docs, 8), f"{config:10s} {cname:6s}", label)


def decode_run(native, docs: list[str], ids: list[list[int]], what: str, label: str) -> None:
    """Decode ``ids`` through the initialized facade against the native
    decode of the same ids, and the engine's ``decode_arrays_device``.
    ``decode_tokens_blob``'s count is zeroed right before each decode and
    read right after."""
    import torch

    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch.ops import decode as D

    what = f"decode {what}"
    nbytes = sum(len(d.encode()) for d in docs)
    walls = []
    for _run in range(2):  # the first run also builds the table
        D.decode_tokens_blob.calls = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = hutoken.batch_decode(ids)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        check(D.decode_tokens_blob.calls > 0, f"{what}: the device path never ran")
    engine = hutoken._get_engine()
    check(engine._prefer_device_decode, f"{what}: the engine prefers the device")
    native_walls = {}
    for threads in (1, 8):
        t0 = time.perf_counter()
        want = native.decode_batch(ids, threads)
        native_walls[threads] = time.perf_counter() - t0
    bad = sum(g != w for g, w in zip(got, want))
    check(len(got) == len(docs) and bad == 0, f"{what}: {bad} documents differ from native")
    check(got == docs, f"{what}: the decode differs from the original text")

    flat = np.concatenate([np.asarray(t, dtype=np.int64) for t in ids])
    offs = np.concatenate(([0], np.cumsum([len(t) for t in ids]))).astype(np.int64)
    D.decode_tokens_blob_tot.calls = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blob, boffs = engine.decode_arrays_device(flat, offs)
    torch.cuda.synchronize()
    arrays_wall = time.perf_counter() - t0
    check(isinstance(blob, torch.Tensor) and blob.is_cuda, f"{what}: the blob is on the card")
    check(D.decode_tokens_blob_tot.calls > 0, f"{what}: decode_arrays_device ran on the card")
    want_blob, want_offs = native.decode_arrays(flat, offs)
    host = blob[: int(boffs[-1])].cpu().numpy().tobytes()
    check(host == want_blob and np.array_equal(boffs, want_offs),
          f"{what}: decode_arrays_device differs from native decode_arrays")
    mb = nbytes / 1e6
    print(f"[{label}] device {what} {mb:.1f} MB, {len(docs)} docs, "
          f"{flat.shape[0]} tokens: equal to native and the text (all docs); "
          f"batch_decode {mb / walls[0]:.2f} MB/s first run ({walls[0]:.3f} s), "
          f"{mb / walls[1]:.2f} MB/s second ({walls[1]:.3f} s), "
          f"decode_tokens_blob calls {D.decode_tokens_blob.calls}; native decode_batch "
          f"{mb / native_walls[1]:.2f} MB/s on 1 thread ({native_walls[1]:.3f} s), "
          f"{mb / native_walls[8]:.2f} MB/s on 8 ({native_walls[8]:.3f} s); "
          f"decode_arrays_device {mb / arrays_wall:.2f} MB/s ({arrays_wall:.3f} s), "
          f"bytes and offsets exact")


def profile_runs(device: str, unique: list[str], label: str) -> None:
    """Phase 7: device busy share (device self time / wall) of one
    cold run of big-merges / unique on each path, with the top kernels,
    and the same run's wall through ``encode_batch_arrays``.  The word
    pipeline's run must show the fused kernel and no ``compact_output``
    span."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import hutoken_tpu_torch as hutoken

    vocab, special, merges = fixture_paths("big-merges")
    for raw_env in ("auto", "0"):
        os.environ["HUTOKEN_TPU_RAW"] = raw_env
        hutoken.initialize(vocab, special, is_byte_encoder=True, device=device, merges_file_path=merges)
        hutoken.batch_encode(unique)  # warm: kernels loaded, allocator filled
        hutoken._get_engine().reset_cache()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            hutoken.batch_encode(unique)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        events = prof.key_averages()
        # device-side events only: an operator's row repeats its kernels' time
        rows = [(e.self_device_time_total, e.key) for e in events if e.device_type == DeviceType.CUDA]
        busy = sum(t for t, _k in rows) / 1e6
        top = ", ".join(f"{k[:40]} {t / 1e3:.3f} ms" for t, k in sorted(rows, reverse=True)[:6] if t > 0)
        spans = sum(e.count for e in events if e.key == "compact_output")
        kernel = "fused_merge_kernel" if raw_env == "0" else "seg_merge_kernel"
        kernel_ms_total = sum(t for t, k in rows if kernel in k) / 1e3
        check(kernel_ms_total > 0, f"profile RAW={raw_env}: {kernel} ran on the card")
        if raw_env == "0":
            check(spans == 0, f"profile RAW=0: {spans} compact_output spans on the word pipeline")
        # the same cold run through the arrays API: no per-document lists
        hutoken._get_engine().reset_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hutoken._get_engine().encode_batch_arrays(unique)
        torch.cuda.synchronize()
        arrays = time.perf_counter() - t0
        print(f"[{label}] profile big-merges unique RAW={raw_env}: wall {wall:.3f} s, "
              f"device self time {busy * 1e3:.3f} ms, busy share {busy / wall:.4f}; "
              f"{kernel} {kernel_ms_total:.3f} ms; compact_output spans {spans}; "
              f"arrays API cold {arrays:.3f} s; top: {top}")
    os.environ.pop("HUTOKEN_TPU_RAW", None)


# ------------------------------------------------------------- phase 8


def train_corpus(mb: float, seed: int) -> bytes:
    """``scripts/benchmark_train.py``'s training text: the Zipf corpus's
    documents joined by spaces, cut to ``mb`` MB."""
    return " ".join(build_corpus(mb + 0.2, seed=seed)).encode()[: int(mb * 1e6)]


def merge_log_of(path: str) -> list[tuple[int, int, int]]:
    with open(path + ".merges", encoding="utf-8") as f:
        return [tuple(int(x) for x in line.split()) for line in f]


def device_train(data: bytes, vocab_size: int, mesh, ckpt: str, every: int = 1 << 30,
                 resume: bool = False):
    """The device trainer to ``vocab_size``, checkpointing at ``ckpt``
    every ``every`` merges and at its end; returns (vocab, merge log,
    wall seconds)."""
    import torch

    from hutoken_tpu_torch.parallel.train import distributed_bbpe_train

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vocab = distributed_bbpe_train(data, vocab_size, mesh=mesh, verbose=False, checkpoint_path=ckpt,
                                   checkpoint_every=every, resume=resume)
    torch.cuda.synchronize()
    return vocab, merge_log_of(ckpt), time.perf_counter() - t0


def host_train(data: bytes, vocab_size: int):
    """``bbpe_train_core``: (vocab, merge log, wall seconds)."""
    from hutoken_tpu_torch.train.bbpe import bbpe_train_core

    log: list = []
    t0 = time.perf_counter()
    vocab = bbpe_train_core(data, vocab_size, verbose=False, merge_log=log)
    return vocab, log, time.perf_counter() - t0


def step_split(mesh, data: bytes, vocab_size: int, log, label: str) -> None:
    """The scan chunk per merge over PROFILE_CHUNKS chunks, at the start
    of training and after replaying ``log`` (the run's end, trimmed as
    the trainer trims): its wall, then under ``torch.profiler`` its
    device time by kernel, sort kernels against the rest, and the device
    operations (kernels, copies, fills) it runs per merge."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from hutoken_tpu_torch.parallel.mesh import shard_batch
    from hutoken_tpu_torch.parallel.train import MIN_MERGE_COUNT, make_scan_train_step

    scan, _fused, merge = make_scan_train_step(vocab_size + 1, mesh, MIN_MERGE_COUNT, SCAN_STEPS)
    steps = PROFILE_CHUNKS * SCAN_STEPS

    def window(ids) -> float:
        """Wall ms per merge of PROFILE_CHUNKS chunks, each downloaded."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for c in range(PROFILE_CHUNKS):
            _ids, stats = scan(ids, 256 + c * SCAN_STEPS)
            stats.cpu()
        return (time.perf_counter() - t0) * 1e3 / steps

    ids = shard_batch(mesh, np.frombuffer(data, np.uint8).astype(np.int32))
    for where, replay in (("start", []), ("end", log)):
        for id1, id2, new_id in replay:
            ids = merge(ids, id1, id2, new_id)
        live = sum(int((s >= 0).sum()) for s in ids)
        ids = [s[: max(live, 1)] for s in ids]
        scan(ids, 256)  # warm
        wall = window(ids)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            profiled = window(ids)
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        total = sum(e.self_device_time_total for e in events) / 1e3 / steps
        sort = sum(e.self_device_time_total for e in events if "sort" in e.key.lower()) / 1e3 / steps
        ops = sum(e.count for e in events) / steps
        top = ", ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3 / steps:.4f}" for e in
                        sorted(events, key=lambda e: -e.self_device_time_total)[:8])
        check(total > 0, f"step split ({where}): device time was traced")
        print(f"[{label}] train step split at the {where} ({live} live ids, {steps} merges): "
              f"wall {wall:.4f} ms per merge ({profiled:.4f} under torch.profiler); device "
              f"{total:.4f} ms per merge = sort {sort:.4f} + rest {total - sort:.4f}, busy share "
              f"{total / wall:.3f}; {ops:.1f} device ops per merge; top ms per merge: {top}")


def no_sync_chunk(mesh, data: bytes, vocab_size: int, what: str) -> None:
    """(e) One chunk under ``torch.cuda.set_sync_debug_mode("error")``:
    any host sync inside the 32 steps raises."""
    import torch

    from hutoken_tpu_torch.parallel.mesh import shard_batch
    from hutoken_tpu_torch.parallel.train import MIN_MERGE_COUNT, _use_candidates, make_scan_train_step

    K = vocab_size + 1
    scan, _f, _m = make_scan_train_step(K, mesh, MIN_MERGE_COUNT, SCAN_STEPS,
                                        use_candidates=_use_candidates(K, mesh.size, len(data)))
    ids = shard_batch(mesh, np.frombuffer(data, np.uint8).astype(np.int32))
    scan(ids, 256)  # warm, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _ids, stats = scan(ids, 256)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    cnts = stats[2].cpu()
    check(int(cnts[0]) > 1, f"no-sync chunk ({what}) merged")
    print(f"no-sync chunk ({what}): {SCAN_STEPS} merges enqueued under sync debug mode 'error', "
          f"no host sync; first counts {cnts[:4].tolist()}")


def device_training(label: str) -> None:
    """Phase 8: the device byte-level trainer, ``bbpe_train(...,
    mesh=data_mesh())``'s path, against the host ``bbpe_train_core``."""
    from hutoken_tpu_torch.parallel import data_mesh

    mesh = data_mesh()
    check(mesh.size == 1 and mesh.devices[0].type == "cuda", f"data_mesh() is one card: {mesh}")
    with tempfile.TemporaryDirectory(prefix="hutoken-train-") as tmp:
        ck = functools.partial(os.path.join, tmp)

        # (a) exactness at depth
        data = train_corpus(EXACT_MB, 0)
        want, want_log, host_s = host_train(data, 256 + EXACT_MERGES)
        got, log, dev_s = device_train(data, 256 + EXACT_MERGES, mesh, ck("exact.txt"))
        check(got == want and log == want_log, "(a) device vocab and merge log == bbpe_train_core")
        print(f"[{label}] (a) {len(data)} B, {len(log)} merges on one card: vocab and merge log "
              f"equal to bbpe_train_core; device {len(log) / dev_s:.1f} merges/s ({dev_s:.2f} s), "
              f"host core {len(want_log) / host_s:.2f} merges/s ({host_s:.1f} s)")

        # (b) full width: the BASELINE config, warmed on another corpus
        data, warm = train_corpus(FULL_MB, 0), train_corpus(FULL_MB, 1)
        device_train(warm, 256 + WARM_MERGES, mesh, ck("warm.txt"))
        got, log, dev_s = device_train(data, 256 + FULL_MERGES, mesh, ck("full.txt"))
        check(len(got) == 256 + FULL_MERGES, f"(b) the vocab is full: {len(got)}")
        _want, want_log, _s = host_train(data, 256 + PREFIX_MERGES)
        check(log[:PREFIX_MERGES] == want_log, f"(b) the first {PREFIX_MERGES} merges == bbpe_train_core")
        print(f"[{label}] (b) device training {len(data)} B, {len(log)} merges to vocab "
              f"{len(got)}: {len(log) / dev_s:.2f} merges/s ({dev_s:.3f} s, warmup of {WARM_MERGES} "
              f"merges on another corpus outside it); first {PREFIX_MERGES} merges equal to bbpe_train_core")
        step_split(mesh, data, 256 + FULL_MERGES, log, label)

        # (e) no host sync inside a chunk, on the main path
        no_sync_chunk(mesh, data, 256 + FULL_MERGES, f"1 shard, {len(data)} B")

        # (c) the multi-shard code: four shards on the card, both pick paths
        shards = data_mesh(SHARDS)
        check(shards.size == SHARDS and all(d.type == "cuda" for d in shards.devices),
              f"data_mesh({SHARDS}) places {SHARDS} shards on the card")
        data = train_corpus(SHARD_MB, 2)
        want, want_log, host_s = host_train(data, 256 + SHARD_MERGES)
        for force in ("0", "1"):
            os.environ["HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES"] = force
            path = "candidates" if force == "1" else "dense"
            got, log, dev_s = device_train(data, 256 + SHARD_MERGES, shards, ck(f"shards{force}.txt"))
            check(got == want and log == want_log, f"(c) {SHARDS} shards, {path}: == bbpe_train_core")
            print(f"[{label}] (c) {SHARDS} shards on one card, {path} pick, {len(data)} B, {len(log)} "
                  f"merges: vocab and merge log equal to bbpe_train_core; {len(log) / dev_s:.1f} merges/s")
            no_sync_chunk(shards, data, 256 + SHARD_MERGES, f"{SHARDS} shards, {path}")
        os.environ.pop("HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES")

        # (d) checkpoint and resume, as tests/test_checkpoint.py
        for m in (mesh, shards):
            straight, straight_log, _s = device_train(data, 300, m, ck(f"straight{m.size}.txt"))
            device_train(data, 280, m, ck(f"resume{m.size}.txt"), every=8)
            resumed, log, _s = device_train(data, 300, m, ck(f"resume{m.size}.txt"), resume=True)
            check(resumed == straight and log == straight_log, f"(d) resumed == straight run ({m.size} shards)")
            print(f"(d) {m.size} shard(s): trained to 280 with checkpoints every 8 merges, resumed to "
                  f"300: equal to a straight run ({len(log)} merges)")


# ------------------------------------------------------------- phase 9


class LoggedVocab(dict):
    """The host core's vocab, logging every spelling it assigns in
    order: its merge log, as the device trainer writes it (``s <hex>``)."""

    def __init__(self, seed: dict):
        super().__init__(seed)
        self.log: list[bytes] = []

    def __setitem__(self, key, value):
        self.log.append(key)
        super().__setitem__(key, value)


def host_string_train(data: bytes, vocab_size: int):
    """``bpe_train_core(strict=False)``: (vocab, merge log, wall seconds).
    The log comes from the vocab it fills, handed in through
    ``_seed_vocab``."""
    from hutoken_tpu_torch.train import bpe as B

    seed = B._seed_vocab
    vocab = LoggedVocab(seed()[0])
    B._seed_vocab = lambda: (vocab, 256)
    try:
        t0 = time.perf_counter()
        got = B.bpe_train_core(data, vocab_size, strict=False, verbose=False)
        secs = time.perf_counter() - t0
    finally:
        B._seed_vocab = seed
    return dict(got), vocab.log, secs


def string_log_of(path: str) -> list[bytes]:
    with open(path + ".merges", encoding="utf-8") as f:
        return [bytes.fromhex(line.split()[1]) for line in f]


def device_string_train(data: bytes, vocab_size: int, mesh, ckpt: str, every: int = 1 << 30,
                        resume: bool = False):
    """The device string trainer: (vocab, merge log, wall seconds,
    STRING_SCAN_STATS of the run)."""
    import torch

    from hutoken_tpu_torch.parallel import train as PT

    for k in PT.STRING_SCAN_STATS:
        PT.STRING_SCAN_STATS[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    vocab = PT.distributed_bpe_train(data, vocab_size, mesh=mesh, verbose=False, checkpoint_path=ckpt,
                                     checkpoint_every=every, resume=resume)
    torch.cuda.synchronize()
    return vocab, string_log_of(ckpt), time.perf_counter() - t0, dict(PT.STRING_SCAN_STATS)


class StringTrace:
    """Counts the string trainer's scan chunks and deep-table steps by
    wrapping the module globals its driver calls, and, with ``profile``,
    runs ``torch.profiler`` over two windows of a real run: chunks 2 to
    STRING_PROFILE_CHUNKS + 1 (with the host's validation between them),
    and STRING_PROFILE_TAIL merges of the tail loop (deep steps with no
    chunk between, from the third on).  ``depth`` cuts every candidate
    table but the deep one to that many rows a shard."""

    def __init__(self, profile: bool = False, depth: int | None = None):
        self.profile, self.depth = profile, depth
        self.chunks = self.deep = self.run = 0
        self.windows: dict[str, dict] = {}
        self.prof = None

    def __enter__(self):
        from hutoken_tpu_torch.parallel import train as PT

        self.PT = PT
        self.saved = (PT.make_string_scan_step, PT._make_shard_ops)
        make_scan, make_ops = self.saved

        def scan_step(mesh, S, k_top=1024):
            scan_fn = make_scan(mesh, S, k_top=k_top)

            def counted(*args):
                self.chunks += 1
                self.run = 0
                if self.profile and self.chunks == 2:
                    self.open("chunks")
                if self.profile and self.chunks == 2 + STRING_PROFILE_CHUNKS:
                    self.close()
                return scan_fn(*args)

            return counted

        def shard_ops(K, mesh, k_top=1024):
            deep = k_top == PT.DEEP_K
            ops = make_ops(K, mesh, k_top=k_top if deep or self.depth is None else self.depth)
            if not deep:
                return ops
            count = ops["count_candidates"]

            def counted(shards):
                self.deep += 1
                self.run += 1
                if self.profile and self.run == 3 and "tail" not in self.windows:
                    self.open("tail")
                if self.profile and self.run == 3 + STRING_PROFILE_TAIL and self.prof is not None:
                    self.close()
                return count(shards)

            return {**ops, "count_candidates": counted}

        PT.make_string_scan_step, PT._make_shard_ops = scan_step, shard_ops
        return self

    def __exit__(self, *exc):
        self.close()
        self.PT.make_string_scan_step, self.PT._make_shard_ops = self.saved

    def open(self, name: str) -> None:
        import torch
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self.prof.start()
        self.windows[name] = {"t0": time.perf_counter(), "chunks": self.chunks, "deep": self.deep,
                              "stats": dict(self.PT.STRING_SCAN_STATS)}

    def close(self) -> None:
        import torch
        from torch.autograd import DeviceType

        if self.prof is None:
            return
        torch.cuda.synchronize()
        name = list(self.windows)[-1]
        w = self.windows[name]
        w["wall_ms"] = (time.perf_counter() - w["t0"]) * 1e3
        self.prof.stop()
        events = [e for e in self.prof.key_averages() if e.device_type == DeviceType.CUDA]
        w["device_ms"] = sum(e.self_device_time_total for e in events) / 1e3
        w["ops"] = sum(e.count for e in events)
        w["top"] = [(e.key[:48], e.self_device_time_total / 1e3) for e in
                    sorted(events, key=lambda e: -e.self_device_time_total)[:6]]
        w["chunks"] = self.chunks - w["chunks"]
        w["deep"] = self.deep - w["deep"]
        w["stats"] = {k: v - w["stats"][k] for k, v in self.PT.STRING_SCAN_STATS.items()}
        self.prof = None

    def tail_merges(self, stats: dict) -> int:
        """Deep steps of the tail loop: every deep step but those of the
        scan driver's fallbacks, each counted as a deep or an exact pick."""
        return self.deep - stats["deep_picks"] - stats["exact_picks"]

    def report(self, label: str) -> None:
        for name, w in self.windows.items():
            per = w["deep"] if name == "tail" else w["chunks"]
            top = ", ".join(f"{k} {ms:.3f}" for k, ms in w["top"])
            print(f"[{label}] string profile, {name} window ({w['chunks']} chunks, {w['deep']} deep "
                  f"steps, stats {w['stats']}): wall {w['wall_ms']:.3f} ms, device {w['device_ms']:.3f} ms "
                  f"= {w['wall_ms'] / max(per, 1):.3f} / {w['device_ms'] / max(per, 1):.3f} ms per "
                  f"{'merge' if name == 'tail' else 'chunk'}, busy share "
                  f"{w['device_ms'] / w['wall_ms']:.3f}, {w['ops'] / max(per, 1):.1f} device ops per "
                  f"{'merge' if name == 'tail' else 'chunk'}; top ms: {top}")


def warm_string(mesh, data: bytes, ck) -> None:
    """Loads every kernel the string trainer runs: a short training and
    one step of each op the deep table and the probes use."""
    import torch

    from hutoken_tpu_torch.parallel import train as PT
    from hutoken_tpu_torch.parallel.mesh import shard_batch

    device_string_train(data, 256 + STRING_WARM_MERGES, mesh, ck("warm.txt"))
    ops = PT._make_shard_ops(2, mesh, k_top=PT.DEEP_K)
    ids = shard_batch(mesh, np.frombuffer(data, np.uint8).astype(np.int32))
    c = torch.full((PT.MAXC,), -1, dtype=torch.int32, device=mesh.devices[0])
    c[0] = 97
    ids = ops["apply_merge_multi"](ids, c, c, 300)
    torch.cat([t.reshape(-1) for t in (*ops["count_candidates"](ids), *ops["probe_pairs"](ids, c, c))]).cpu()


def string_no_sync_chunk(mesh, data: bytes, what: str) -> None:
    """(e) One speculative chunk under ``set_sync_debug_mode("error")``."""
    import torch

    from hutoken_tpu_torch.parallel import train as PT
    from hutoken_tpu_torch.parallel.mesh import shard_batch

    scan = PT.make_string_scan_step(mesh, 16, k_top=8192)
    ids = shard_batch(mesh, np.frombuffer(data, np.uint8).astype(np.int32))
    q = torch.full((2, PT.PROBE_P), -1, dtype=torch.int32, device=mesh.devices[0])
    q[:, 0] = 101  # the pair "ee", watched
    scan(ids, 256, q[0], q[1])  # warm, outside the check
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        _ids, rows = scan(ids, 256, q[0], q[1])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    c = rows[:, -1].cpu()
    check(int(c[0]) > 1, f"string no-sync chunk ({what}) merged")
    print(f"string no-sync chunk ({what}): 16 sub-steps enqueued under sync debug mode 'error', "
          f"no host sync; first pair counts {c[:4].tolist()}")


def string_training(label: str) -> None:
    """Phase 9: the device string trainer, ``bpe_train(...,
    mesh=data_mesh())``'s path, against the host
    ``bpe_train_core(strict=False)``."""
    from hutoken_tpu_torch.parallel import data_mesh

    mesh = data_mesh()
    with tempfile.TemporaryDirectory(prefix="hutoken-string-") as tmp:
        ck = functools.partial(os.path.join, tmp)
        t0 = time.perf_counter()
        warm_string(mesh, train_corpus(EXACT_MB, 1), ck)
        print(f"[{label}] string warmup ({STRING_WARM_MERGES} merges on seed 1, one deep step): "
              f"{time.perf_counter() - t0:.1f} s")

        # (a) exactness at scripts/benchmark_train.py --mode string's config, timed
        t0 = time.perf_counter()
        data = train_corpus(EXACT_MB, 0)
        want, want_log, host_s = host_string_train(data, 256 + STRING_MERGES)
        with StringTrace() as tr:
            got, log, dev_s, stats = device_string_train(data, 256 + STRING_MERGES, mesh, ck("exact.txt"))
        check(got == want and log == want_log,
              "(a) string vocab and merge log == bpe_train_core(strict=False)")
        print(f"[{label}] (a) string training {len(data)} B, {len(log)} merges on one card: vocab and "
              f"merge log equal to bpe_train_core(strict=False); device {len(log) / dev_s:.2f} merges/s "
              f"({dev_s:.3f} s, {tr.chunks} chunks, tail loop took over: {tr.tail_merges(stats) > 0} "
              f"({tr.tail_merges(stats)} tail merges), stats {stats}); host core "
              f"{len(want_log) / host_s:.2f} merges/s ({host_s:.1f} s); sub-phase "
              f"{time.perf_counter() - t0:.1f} s")

        # (b) the BASELINE's corpus to a prefix of its merges, then a
        # profiled run of (a)'s config
        t0 = time.perf_counter()
        data4 = train_corpus(FULL_MB, 0)
        with StringTrace() as tr:
            got4, log4, dev4_s, stats4 = device_string_train(data4, 256 + STRING_FULL_MERGES, mesh,
                                                             ck("full.txt"))
        _w, want_log4, _s = host_string_train(data4, 256 + PREFIX_MERGES)
        check(log4[:PREFIX_MERGES] == want_log4, f"(b) the first {PREFIX_MERGES} string merges == host core")
        print(f"[{label}] (b) string training {len(data4)} B, {len(log4)} merges to vocab {len(got4)}: "
              f"{len(log4) / dev4_s:.2f} merges/s ({dev4_s:.3f} s, {tr.chunks} chunks, tail loop took "
              f"over: {tr.tail_merges(stats4) > 0} ({tr.tail_merges(stats4)} tail merges), stats {stats4}); "
              f"first {PREFIX_MERGES} merges equal to the host core; sub-phase "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with StringTrace(profile=True) as tr:
            got, log, dev_s, stats = device_string_train(data, 256 + STRING_MERGES, mesh, ck("prof.txt"))
        check(log == want_log, "(b) the profiled run == (a)")
        tr.report(label)
        check("chunks" in tr.windows, "(b) a chunk window was profiled")
        print(f"[{label}] (b) profiled run: {len(log) / dev_s:.2f} merges/s under the windows; sub-phase "
              f"{time.perf_counter() - t0:.1f} s")

        # (e) no host sync inside a chunk
        string_no_sync_chunk(mesh, data, f"1 shard, {len(data)} B")

        # (c) four shards on the card, candidate tables cut to STRING_DEPTH rows
        t0 = time.perf_counter()
        shards = data_mesh(SHARDS)
        data = train_corpus(SHARD_MB, 2)
        want, want_log, _s = host_string_train(data, 256 + STRING_SHARD_MERGES)
        with StringTrace(depth=STRING_DEPTH) as tr:
            got, log, dev_s, stats = device_string_train(data, 256 + STRING_SHARD_MERGES, shards,
                                                         ck("shards.txt"))
        check(got == want and log == want_log, f"(c) {SHARDS} shards at depth {STRING_DEPTH}: == host core")
        check(stats["deep_picks"] > 0, f"(c) the deep pick ran: {stats}")
        print(f"[{label}] (c) {SHARDS} shards on one card, candidate depth {STRING_DEPTH}, {len(data)} B, "
              f"{len(log)} merges: vocab and merge log equal to the host core; {len(log) / dev_s:.2f} "
              f"merges/s, stats {stats}, {tr.deep} deep steps; sub-phase {time.perf_counter() - t0:.1f} s")
        string_no_sync_chunk(shards, data, f"{SHARDS} shards")

        # (d) checkpoint and resume
        t0 = time.perf_counter()
        for m in (mesh, shards):
            straight, straight_log, _s, _st = device_string_train(data, 300, m, ck(f"s{m.size}.txt"))
            device_string_train(data, 280, m, ck(f"r{m.size}.txt"), every=8)
            resumed, log, _s, _st = device_string_train(data, 300, m, ck(f"r{m.size}.txt"), resume=True)
            check(resumed == straight and log == straight_log,
                  f"(d) string resume == straight run ({m.size} shards)")
            print(f"(d) {m.size} shard(s): string training to 280 with checkpoints every 8 merges, "
                  f"resumed to 300: equal to a straight run ({len(log)} merges)")
        print(f"[{label}] (d) sub-phase {time.perf_counter() - t0:.1f} s")


# ------------------------------------------------------------ phase 10


def sharded_run(device: str, ctx, docs: list[str], mesh, what: str, label: str,
                profile_it: bool = False) -> list:
    """(a) One vocabulary and corpus on the sharded engine
    (``TorchTokenizer(ctx, mesh=mesh)``, ``HUTOKEN_TPU_RAW=auto``) and
    the single-device engine (``HUTOKEN_TPU_RAW=0``: the same word
    pipeline), cold runs in turns single, sharded, sharded, single, each
    run's ids equal to the first's.  The counts are zeroed right before
    each sharded run and read right after: the fused kernel (narrow or
    wide) must have launched on every shard, as many times as the engine
    sent blocks, and ``seg_merge`` never.  Returns the per-shard
    launches of the first sharded run."""
    from hutoken_tpu_torch.engine import TorchTokenizer

    single = TorchTokenizer(ctx, device=device)
    sharded = TorchTokenizer(ctx, mesh=mesh)
    check(len({id(t) for t in sharded._shard_tables}) == len(set(mesh.devices)), f"{what}: one table replica a card")
    nbytes = sum(len(d.encode()) for d in docs)

    def cold(engine, raw_env: str):
        os.environ["HUTOKEN_TPU_RAW"] = raw_env
        engine.reset_cache()
        zero_launch_counts()
        engine.stat_shard_fused = [0] * len(engine.stat_shard_fused)
        sync(device)
        t0 = time.perf_counter()
        ids = engine.encode_batch(docs)
        sync(device)
        return ids, time.perf_counter() - t0, launch_counts(), list(engine.stat_shard_fused)

    want, t_one, _c, _s = cold(single, "0")
    runs = [cold(sharded, "auto"), cold(sharded, "auto")]
    again, t_one2, _c, _s = cold(single, "0")
    check(again == want, f"{what}: the single-device engine repeats itself")
    per_shard = runs[0][3]
    for ids, _t, counts, shards in runs:
        bad = sum(g != w for g, w in zip(ids, want))
        check(len(ids) == len(docs) and bad == 0, f"{what}: {bad} documents differ from the single-device engine")
        fused = counts["fused_merge"] + counts["fused_merge_wide"]
        check(counts["seg_merge"] == 0, f"{what}: the raw path ran under a mesh: {counts}")
        check(min(shards) > 0 and sum(shards) == fused,
              f"{what}: fused launches per shard {shards}, {fused} counted by the wrapper")
        check(shards == per_shard, f"{what}: a cold run launches as the first did ({shards} vs {per_shard})")
    busy = ""
    if profile_it:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        sharded.reset_cache()
        sync(device)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            sharded.encode_batch(docs)
            sync(device)
            wall = time.perf_counter() - t0
        dev = sum(e.self_device_time_total for e in prof.key_averages() if e.device_type == DeviceType.CUDA)
        busy = f"; profiled sharded run: wall {wall:.3f} s, device {dev / 1e3:.3f} ms, busy share {dev / 1e6 / wall:.4f}"
    mb = nbytes / 1e6
    t_sh = [t for _i, t, _c, _s in runs]
    print(f"[{label}] (a) {what}: {mb:.1f} MB, {len(docs)} docs, sharded on {mesh.size} shards == single "
          f"device (all docs); cold MB/s single {mb / t_one:.2f} / sharded {mb / t_sh[0]:.2f} / "
          f"{mb / t_sh[1]:.2f} / single {mb / t_one2:.2f}; fused launches per shard {per_shard} "
          f"({'wide' if runs[0][2]['fused_merge_wide'] else 'narrow'}), seg_merge 0; "
          f"device words {sharded.stat_device_words}{busy}")
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return per_shard


def sharded_encode(device: str, zipf: list[str], unique: list[str], label: str) -> dict:
    """(a) the sharded engine on ``data_mesh(MESH_SHARDS)`` (and on
    ``data_mesh()`` when there are more cards): big-merges over both
    corpora, wide-merges over the unique one.  Returns the per-shard
    launches of the 4-shard runs by run."""
    import torch

    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.parallel import data_mesh

    meshes = [data_mesh(MESH_SHARDS, device)]
    if device == "cuda" and torch.cuda.device_count() > 1:
        meshes.append(data_mesh())
    out = {}
    with tempfile.TemporaryDirectory(prefix="hutoken-wide-") as wide_dir:
        big = TokenizerContext.load(*fixture_paths("big-merges")[:2], is_byte_encoder=True,
                                    merges_file_path=fixture_paths("big-merges")[2])
        vocab, special, merges = wide_paths(wide_dir)["wide-merges"]
        wide = TokenizerContext.load(vocab, special, is_byte_encoder=True, merges_file_path=merges)
        for mesh in meshes:
            for config, ctx, cname, docs in (("big-merges", big, "zipf", zipf),
                                             ("big-merges", big, "unique", unique),
                                             ("wide-merges", wide, "unique", unique)):
                t0 = time.perf_counter()
                what = f"{config} {cname} on {mesh.size} shards"
                shards = sharded_run(device, ctx, docs, mesh, what, label,
                                     profile_it=(config, cname) == ("big-merges", "unique"))
                if mesh is meshes[0]:
                    out[f"{config} {cname}"] = shards
                print(f"(a) {what}: sub-phase {time.perf_counter() - t0:.1f} s")
    return out


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def mesh_trainers(mesh) -> dict:
    """Both trainers at (c)'s config on ``mesh``: vocabs and seconds."""
    from hutoken_tpu_torch.parallel.train import distributed_bbpe_train, distributed_bpe_train

    data = train_corpus(SHARD_MB, 2)
    out = {}
    for name, train in (("bbpe", distributed_bbpe_train), ("string", distributed_bpe_train)):
        t0 = time.perf_counter()
        out[name] = train(data, 256 + SHARD_MERGES, mesh=mesh, verbose=False)
        sync(mesh.devices[0].type)
        out[name + "_s"] = time.perf_counter() - t0
    return out


def peer(argv: list[str]) -> int:
    """One process of (c) or (d): ``--peer RANK WORLD ADDR BACKEND
    DEVICE N_LOCAL OUT`` joins the group, trains both trainers on
    ``global_data_mesh(N_LOCAL, DEVICE)`` and writes the vocabs to OUT."""
    import pickle

    import torch.distributed as dist

    from hutoken_tpu_torch.parallel.multihost import global_data_mesh, initialize_distributed

    rank, world, addr, backend, device, n_local, out = argv
    if backend == "nccl":
        os.environ["LOCAL_RANK"] = rank  # one rank per card
    initialize_distributed(addr, int(world), int(rank), backend=backend)
    mesh = global_data_mesh(int(n_local), device)
    got = mesh_trainers(mesh)
    dist.destroy_process_group()
    got["mesh"] = (mesh.size, mesh.process_index, mesh.process_count, [str(d) for d in mesh.devices])
    with open(out, "wb") as f:
        pickle.dump(got, f)
    return 0


def peer_world(device: str, backend: str, n_local: int, want: dict, what: str, label: str) -> None:
    """Two ``peer`` processes; rank 0's vocabs (and rank 1's) must equal
    the host cores'."""
    import pickle
    import subprocess

    addr = f"localhost:{free_port()}"
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hutoken-peers-") as tmp:
        stems = [os.path.join(tmp, f"rank{rank}") for rank in range(2)]
        procs = []
        try:
            for rank, stem in enumerate(stems):
                with open(stem + ".log", "w") as log:
                    procs.append(subprocess.Popen(
                        [sys.executable, os.path.join(HERE, "chip_smoke.py"), "--peer", str(rank), "2",
                         addr, backend, device, str(n_local), stem + ".pkl"],
                        stdout=log, stderr=subprocess.STDOUT))
            # until both end, one fails (the other would wait on it) or time is up
            deadline = time.monotonic() + PEER_TIMEOUT
            rcs = [None] * len(procs)
            while time.monotonic() < deadline:
                rcs = [p.poll() for p in procs]
                if None not in rcs or any(rc not in (None, 0) for rc in rcs):
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = []
        for rank, (rc, stem) in enumerate(zip(rcs, stems)):
            if rc != 0:
                with open(stem + ".log") as f:
                    bad.append(f"rank {rank} exited {rc} (None: stopped here):\n{f.read()[-3000:]}")
        check(not bad, f"({what}) " + "\n".join(bad))
        got = []
        for stem in stems:
            with open(stem + ".pkl", "rb") as f:
                got.append(pickle.load(f))
    for rank, g in enumerate(got):
        check(g["mesh"][:3] == (2 * n_local, rank, 2), f"({what}) rank {rank}'s mesh {g['mesh']}")
        check(g["bbpe"] == want["bbpe"], f"({what}) rank {rank}: bbpe == bbpe_train_core")
        check(g["string"] == want["string"], f"({what}) rank {rank}: string == bpe_train_core(strict=False)")
    print(f"[{label}] ({what}) 2 processes over {backend}, {n_local} shard(s) each on "
          f"{got[0]['mesh'][3]} / {got[1]['mesh'][3]}: {SHARD_MERGES} merges on {SHARD_MB * 1e3:.0f} KB, "
          f"bbpe and string vocabs equal to the host cores on both ranks; rank 0 bbpe "
          f"{got[0]['bbpe_s']:.2f} s, string {got[0]['string_s']:.2f} s (first use in the process "
          f"included); sub-phase {time.perf_counter() - t0:.1f} s")


def multi_process_training(device: str, label: str) -> None:
    """(b) a 1-process NCCL world in this process; (c) two gloo
    processes sharing the card, two shards each; (d) two NCCL processes,
    one per card, when there are two cards."""
    import torch
    import torch.distributed as dist

    from hutoken_tpu_torch.parallel.multihost import global_data_mesh, initialize_distributed

    t0 = time.perf_counter()
    data = train_corpus(SHARD_MB, 2)
    want = {"bbpe": host_train(data, 256 + SHARD_MERGES)[0],
            "string": host_string_train(data, 256 + SHARD_MERGES)[0]}
    print(f"host cores at {SHARD_MB * 1e3:.0f} KB / {SHARD_MERGES} merges: {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    addr = f"localhost:{free_port()}"
    initialize_distributed(addr, 1, 0)
    initialize_distributed(addr, 1, 0)  # a second call is a no-op
    try:
        backend = "nccl" if device == "cuda" else "gloo"
        check(dist.get_backend() == backend and dist.get_world_size() == 1, f"(b) a 1-process {backend} world")
        mesh = global_data_mesh(device=device)
        one = torch.ones(1, device=mesh.devices[0])
        dist.all_reduce(one)
        check(int(one.item()) == 1, f"(b) an all_reduce over one {backend} rank")
        got = mesh_trainers(mesh)
    finally:
        dist.destroy_process_group()
    check(got["bbpe"] == want["bbpe"] and got["string"] == want["string"], "(b) vocabs == the host cores")
    print(f"[{label}] (b) 1-process {backend} world (initialized twice), global_data_mesh() of {mesh.size} "
          f"shard(s): bbpe {got['bbpe_s']:.2f} s, string {got['string_s']:.2f} s, equal to the host cores; "
          f"sub-phase {time.perf_counter() - t0:.1f} s")

    peer_world(device, "gloo", 2, want, "c", label)
    if device == "cuda" and torch.cuda.device_count() > 1:
        peer_world(device, "nccl", 1, want, "d", label)
    else:
        print(f"[{label}] (d) not run: two NCCL processes need a second card, and this machine has "
              f"{torch.cuda.device_count()}")


# ------------------------------------------------------------ phase 11


def hole_ctx(directory: str, alias: bool):
    """The vocabularies of the 16-bit repair's witness
    (``tests/test_torch_quirk_vocab.py``), 258 lines each: the 256 GPT-2
    byte seeds with "he" = 70,000 and "hel" = 70,001, or (``alias``)
    byte "z" moved to 70,002 with "he" = 4,466 and "hec" = 257, whose
    pairs all fit 16 bits but whose seed's 16-bit key is that of the
    rule ("he", "c")."""
    from hutoken_tpu_torch.bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table
    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.formats import write_special_chars_file, write_vocab_file

    b2u = gpt2_bytes_to_unicode()

    def spell(s: bytes) -> bytes:
        return "".join(b2u[x] for x in s).encode("utf-8")

    id2str = {b: b2u[b].encode("utf-8") for b in range(256)}
    if alias:
        id2str[70002] = id2str.pop(ord("z"))
        id2str[4466], id2str[257] = spell(b"he"), spell(b"hec")
    else:
        id2str[70000], id2str[70001] = spell(b"he"), spell(b"hel")
    name = "alias" if alias else "holes"
    vocab = os.path.join(directory, f"{name}-vocab.txt")
    special = os.path.join(directory, f"{name}-special.txt")
    write_vocab_file(vocab, id2str)
    write_special_chars_file(special, gpt2_special_chars_table())
    return TokenizerContext.load(vocab, special, is_byte_encoder=True)


def hole_docs() -> list[str]:
    """``HOLE_WORDS`` words of 2-11 bytes and ``HOLE_LONG_WORDS`` of
    33-100 bytes (the eager bucket), each "hel", "hec", "zc" or "z" and
    letters of "abcdefgxyz", 50 and 20 words a document."""
    rng = np.random.default_rng(11)
    letters = np.array(list("abcdefgxyz"))
    heads = ("hel", "hec", "zc", "z")

    def words(n, lo, hi):
        return [heads[h] + "".join(letters[rng.integers(0, 10, k)])
                for h, k in zip(rng.integers(0, 4, n), rng.integers(lo, hi + 1, n))]

    short, long = words(HOLE_WORDS, 1, 8), words(HOLE_LONG_WORDS, 30, 97)
    return ([" ".join(short[i : i + 50]) for i in range(0, len(short), 50)]
            + [" ".join(long[i : i + 20]) for i in range(0, len(long), 20)])


def hole_vocabularies(device: str, label: str) -> None:
    """Phase 11's first step: the 16-bit repair on the card.  On both
    vocabularies of :func:`hole_ctx` the table is the wide one and the
    output 32-bit; the wide fused kernel is held to its twin on the
    read prefix at widths 8, 16 and 32, and the engine, under
    ``HUTOKEN_TPU_RAW=0`` and ``=1``, to the native engine on every
    document (and the oracle on a sample) through ``encode_batch`` and
    ``encode_batch_arrays``, the counts zeroed right before each run:
    the wide kernel launched, the narrow and segmented kernels not."""
    import torch

    from hutoken_tpu_torch import oracle
    from hutoken_tpu_torch.engine import TorchTokenizer
    from hutoken_tpu_torch.native import NativeEngine
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops.merge import compact_output
    from hutoken_tpu_torch.tables import build_encoder_tables, device_tables, max_token_id

    docs = hole_docs()
    nbytes = sum(len(d.encode()) for d in docs)
    rng = np.random.default_rng(0)
    with tempfile.TemporaryDirectory(prefix="hutoken-holes-") as tmp:
        for alias in (False, True):
            t0 = time.perf_counter()
            name = "alias" if alias else "holes"
            top = 70002 if alias else 70001
            ctx = hole_ctx(tmp, alias)
            tab = device_tables(build_encoder_tables(ctx), ctx, device)
            u16 = max_token_id(ctx.vocab) < 0xFFFF
            check(ctx.vocab.size == 258 and tab.wide and not u16,
                  f"(11) {name}: 258 lines, the wide table and 32-bit output")
            for width in (8, 16, 32):
                raw, lens = corpus_block(docs, rng, BLOCK_WORDS, width)
                r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
                ids, counts = FM.fused_merge_plain(tab, r, n)
                want = compact_output(ids, u16)
                read = BLOCK_WORDS + int(counts.sum())
                got = FM.merge_words_from_bytes_fused(tab, r, n, u16)
                check(torch.equal(got[:read], want[:read]), f"(11) {name}: wide kernel == twin, L={width}")
                check(int(ids.max()) == top, f"(11) {name}: the block gives id {top} (L={width})")
            want = NativeEngine(ctx).encode_batch(docs, 8)
            sample = [int(i) for i in rng.choice(len(docs), ORACLE_SAMPLE, replace=False)]
            check(all(want[i] == oracle.encode(ctx, docs[i]) for i in sample), f"(11) {name}: native == oracle")
            check(sum(w.count(top) for w in want) > HOLE_WORDS // 8, f"(11) {name}: id {top} in the output")
            for raw_env in ("0", "1"):
                os.environ["HUTOKEN_TPU_RAW"] = raw_env
                tok = TorchTokenizer(ctx, device=device)
                zero_launch_counts()
                got = tok.encode_batch(docs)
                sync(device)
                counts = launch_counts()
                bad = sum(g != w for g, w in zip(got, want))
                check(len(got) == len(docs) and bad == 0, f"(11) {name} RAW={raw_env}: {bad} documents differ")
                check(counts["fused_merge_wide"] > 0 and counts["fused_merge"] == 0 and counts["seg_merge"] == 0,
                      f"(11) {name} RAW={raw_env}: the wide kernel alone must run: {counts}")
                check(tok.stat_device_words > 0, f"(11) {name} RAW={raw_env}: no word reached the card")
                tok.reset_cache()
                flat, offs = tok.encode_batch_arrays(docs)
                check(all(flat[offs[i] : offs[i + 1]].tolist() == want[i] for i in range(len(docs))),
                      f"(11) {name} RAW={raw_env}: encode_batch_arrays")
                print(f"[{label}] (11) {name} vocabulary (max id {max_token_id(ctx.vocab)}, 258 lines) "
                      f"RAW={raw_env}: {nbytes / 1e6:.2f} MB, {len(docs)} docs equal to native (all) and "
                      f"oracle ({ORACLE_SAMPLE}), encode_batch_arrays too; wide kernel == twin at L=8/16/32; "
                      f"launches {counts}; device words {tok.stat_device_words}", flush=True)
            os.environ.pop("HUTOKEN_TPU_RAW", None)
            print(f"(11) {name} vocabulary: sub-phase {time.perf_counter() - t0:.1f} s", flush=True)


def run_driver(what: str, fn, want_kernels=()) -> str:
    """One driver call, in this process, with the launch counts zeroed
    right before it and read right after; its standard output is
    captured, printed and returned.  Each kernel of ``want_kernels`` must
    have launched in the call."""
    import io

    buf = io.StringIO()
    zero_launch_counts()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = fn()
    secs = time.perf_counter() - t0
    counts = launch_counts()
    out = buf.getvalue()
    print(out, end="")
    check(rc in (None, 0), f"{what}: returned {rc}")
    for k in want_kernels:
        check(counts[k] > 0, f"{what}: the {k} kernel never launched ({counts})")
    print(f"(11) {what}: launches {counts}; sub-phase {secs:.1f} s", flush=True)
    return out


def drivers(label: str) -> None:
    """Phase 11: the port's drivers (``hutoken_tpu_torch/entry.py`` and
    ``scripts/``) in this process on the card."""
    from hutoken_tpu_torch import entry
    from hutoken_tpu_torch.scripts import benchmark_sharded, benchmark_train, profile_merge, profile_raw

    # entry()'s fn on the card held to the fused twin, then dryrun_multichip(4)
    run_driver("entry", lambda: entry.main(["--shards", "4"]), ("fused_merge",))
    run_driver("benchmark_train --mb 1 --merges 1000",
               lambda: benchmark_train.main(["--mb", "1", "--merges", "1000"]))
    run_driver("benchmark_sharded", lambda: benchmark_sharded.main(["--shards", "1,2,4"]), ("fused_merge",))
    out = run_driver("profile_merge", lambda: profile_merge.main([]),
                     ("fused_merge", "fused_merge_wide", "id_merge", "id_merge_wide"))
    check(out.count("eager fixed point") == 5 and out.count("equal to the eager twin") == 5,
          "profile_merge: two long-word blocks on each table and a char-mode block, kernel and twin")
    out = run_driver("profile_raw --mode both --mb 8",
                     lambda: profile_raw.main(["--mode", "both", "--mb", "8"]), ("seg_merge", "fused_merge"))
    check("[raw] run 0 host stages" in out, "profile_raw: the raw path's stage split")


def merge_entry(name, source, replaces, launches, per_run, res, key, by) -> dict:
    """A kernels-line entry of a merge kernel: ``res["by"][key]`` is the
    row its ms, plain_ms and bound come from; ``by`` names the other
    rows' keys."""
    row = res["by"][key]
    return {
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": replaces,
        "launches": launches,
        "launches_per_run": per_run,
        "max_abs_err": res["max_abs_err"],
        "ms": row["ms"],
        "plain_ms": row["plain_ms"],
        "bound_ms": row["bound_ms"],
        "bound_by": row["bound_by"],
        "library_ms": None,  # no single PyTorch call computes a BPE merge
        "share": row["bound_ms"] / row["ms"],
        "shape": key,
        f"ms_by_{by}": {k: r["ms"] for k, r in res["by"].items()},
        f"plain_ms_by_{by}": {k: r["plain_ms"] for k, r in res["by"].items()},
        f"bound_ms_by_{by}": {k: r["bound_ms"] for k, r in res["by"].items()},
        **({"compact_output_ms_by_block": {k: r["compact_output_ms"] for k, r in res["by"].items()}}
           if "compact_output_ms" in row else {}),
        **({"rounds_by_block": {k: r["rounds"] for k, r in res["by"].items()},
            "cold_ms_by_block": {k: r["cold_ms"] for k, r in res["by"].items()},
            "edges_by_block": res["edges"]}
           if "rounds" in row else {}),
    }


# ------------------------------------------------------------ phase 12


def docs_mb(docs: list[str], mb: float) -> list[str]:
    """The first documents of ``docs`` that hold ``mb`` MB."""
    out, total = [], 0
    for d in docs:
        if total >= mb * 1e6:
            break
        out.append(d)
        total += len(d.encode())
    return out


def long_word_docs(zipf: list[str]) -> list[str]:
    """LONG_DOCS Zipf documents, each followed by LONG_PER_DOC compounds
    of 33-128 bytes glued from the corpus's alphabetic words
    (``profile_merge.compound_words``)."""
    from hutoken_tpu_torch.scripts.profile_merge import compound_words

    comp = [c[1:].decode() for c in compound_words(zipf, LONG_DOCS * LONG_PER_DOC)]
    k = LONG_PER_DOC
    return [zipf[i] + " " + " ".join(comp[i * k:(i + 1) * k]) for i in range(LONG_DOCS)]


def id_runs(device: str, runs: list, label: str) -> dict:
    """(b) and (c): one facade ``initialize`` a run, then ``encode_run``
    (counts zeroed right before each of its runs and read right after).
    ``runs`` holds (name, (vocab, special, merges or None), byte mode,
    prefix, docs, HUTOKEN_TPU_RAW, path).  Returns run name -> the cold
    run's launch counts."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch.native import NativeEngine

    by_run = {}
    for name, (vocab, special, merges), byte_mode, prefix, docs, raw_env, path in runs:
        t0 = time.perf_counter()
        os.environ["HUTOKEN_TPU_RAW"] = raw_env
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=byte_mode, prefix=prefix, device=device, **kw)
        _got, by_run[name], _max_id = encode_run(NativeEngine(hutoken._ctx), docs, name, path, label)
        print(f"(12) {name}: sub-phase {time.perf_counter() - t0:.1f} s", flush=True)
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return by_run


def id_vs_plain(device: str, zipf: list[str], unique: list[str], label: str, char_ctx,
                tables: dict) -> dict:
    """(d) The id kernel against its twin (``merge_words_packed`` /
    ``merge_words_from_bytes_packed``) on the card, exactly, on the
    prefix the host reads, at the engine's shapes and output types:
    char-mode ids of corpus words, compound bytes on the narrow and the
    wide table, ids on hand-built wide rules ranked from 2^24 whose
    first minimum in each row lies at a position of 32 or more, and pad
    rows; then the edge blocks (``profile_merge.edge_block``) of each of
    those four rule sets at widths 31-128.  Each block is one launch with
    no host sync (under ``set_sync_debug_mode("error")``), timed with the
    sleep-led timer back to back and under a cold L2 beside the twin's
    rounds (the most merges of any row, plus the round that finds none);
    the five engine-shaped blocks also beside the twin and the bound (the
    bytes in and out, and the pair table's slots as the twin probes them,
    with no minsuper bound: the kernel reads none).  ``char_ctx`` is the
    char-mode vocabulary's context; ``tables`` maps "big-merges" and
    "wide-merges" to their (DeviceTables on the card, rules)."""
    import types

    import torch

    from hutoken_tpu_torch import corpora as C
    from hutoken_tpu_torch.engine import TorchTokenizer
    from hutoken_tpu_torch.ops import id_merge as IM
    from hutoken_tpu_torch.ops import merge as TM
    from hutoken_tpu_torch.scripts.profile_merge import (
        EDGE_WIDTHS,
        block_of,
        char_block_words,
        compound_words,
        edge_block,
    )
    from hutoken_tpu_torch.tables import build_encoder_tables, build_pair_table, device_tables

    (w32, l32), (w128, l128) = ID_BLOCKS
    char_engine = TorchTokenizer(char_ctx, device=device)
    char_tab = char_engine.dev_tables
    words, seeds = char_block_words(char_engine, zipf[:4000] + unique, w32)
    check(len(words) == w32, f"(12d) {len(words)} distinct corpus words of 2-32 char-mode ids")
    char_ids = np.full((w32, l32), -1, dtype=np.int32)
    for i, sd in enumerate(seeds):
        char_ids[i, : len(sd)] = sd
    rm = C.high_rank_rules()
    rules, _marker = rm
    enc = types.SimpleNamespace(pair_table=build_pair_table(rules), pairs=rules, byte_seed_ids=None)
    high_tab = device_tables(enc, None, device)
    check(high_tab.wide and min(r for r, _m in rules.values()) >= C.HIGH_RANK, "(12d) hand-built wide rules")
    _w, raw, lens = block_of(compound_words(zipf, w128), l128)
    (big, big_rules), (wide, wide_rules) = tables["big-merges"], tables["wide-merges"]
    cases = {
        f"char {w32}x{l32}": (char_tab, char_ids, None, False),
        f"big-merges {w128}x{l128}": (big, raw, lens, True),
        f"wide-merges {w128}x{l128}": (wide, raw, lens, False),
        f"high-rank {w128}x{l128}": (high_tab, C.high_rank_block(rm, w128, l128), None, False),
        f"pad rows {w128}x{l128}": (char_tab, np.full((w128, l128), -1, dtype=np.int32), None, False),
    }
    char_rules = build_encoder_tables(char_ctx).pairs
    edge_sets = {"char": (char_tab, char_rules), "big-merges": (big, big_rules),
                 "wide-merges": (wide, wide_rules), "high-rank": (high_tab, rules)}
    for name, (tab, rs) in edge_sets.items():
        for width in EDGE_WIDTHS:
            cases[f"edges {name} {width}"] = (tab, edge_block(rs, width, seed=width), None, not tab.wide)
    result = {"max_abs_err": 0, "by": {}, "edges": {}}
    for key, (tab, x, n, u16) in cases.items():
        xd = torch.from_numpy(x).to(device)
        if n is None:
            kernel = functools.partial(IM.id_merge, tab, xd, u16)
            twin = functools.partial(TM.merge_words_packed, tab, xd, u16)
            in_bytes = x.nbytes
        else:
            nd = torch.from_numpy(n).to(device)
            kernel = functools.partial(IM.id_merge_bytes, tab, xd, nd, u16)
            twin = functools.partial(TM.merge_words_from_bytes_packed, tab, xd, nd, u16)
            in_bytes = x.nbytes + n.nbytes + 4 * 256  # + the byte seeds
        W, L = x.shape
        with probe_log() as pairs:
            want = twin()
        counts = want[:W].to(torch.int64) & 0xFFFF
        read = W + int(counts.sum())
        launches = IM.id_merge.launches + IM.id_merge.wide_launches
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = kernel()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(IM.id_merge.launches + IM.id_merge.wide_launches == launches + 1,
              f"(12d) one launch on {key}")
        err = int((got[:read].to(torch.int64) - want[:read].to(torch.int64)).abs().max())
        result["max_abs_err"] = max(result["max_abs_err"], err)
        check(err == 0, f"(12d) id kernel == twin on {key}")
        seeded = (x >= 0).sum(axis=1) if n is None else n
        merged = int((counts.cpu().numpy() < seeded).sum())
        rounds = int((seeded - counts.cpu().numpy()).max()) + 1
        if key.startswith("edges"):
            check(merged > 0, f"(12d) {key}: no row merged")
            warm, cold = cuda_time(kernel), cuda_time(kernel, cold=True)
            result["edges"][key] = {"rounds": rounds, "ms": warm, "cold_ms": cold}
            print(f"[{label}] (12d) id kernel {key} ({'wide' if tab.wide else 'narrow'}): packed "
                  f"prefix of {read} entries equal to the twin (max_abs_err 0, tolerance 0), one "
                  f"launch, no host sync, {merged} of {W} rows merged, {rounds} rounds; kernel "
                  f"{warm:.4f} ms ({warm / rounds * 1e3:.3f} us a round), cold L2 {cold:.4f} ms "
                  f"({cold / rounds * 1e3:.3f} us a round)", flush=True)
            continue
        if key.startswith("pad"):
            check(read == W and int(counts.max()) == 0, f"(12d) {key}: every count 0")
        else:
            check(merged > W // 2, f"(12d) {key}: only {merged} of {W} rows merged")
        scan_bytes = 8 * (1 + -(-W // IM.words_per_block(L)))
        nbytes = (in_bytes + probed_slot_bytes(tab, pairs, with_minsuper=False)
                  + read * want.element_size() + scan_bytes)
        # in turns, inside this call; warm, the pair table stays in L2
        k1 = cuda_time(kernel)
        p1 = time_ms(twin, 2)
        k2 = cuda_time(kernel)
        cold = cuda_time(kernel, cold=True)
        row = {"ms": (k1 + k2) / 2, "plain_ms": p1, "cold_ms": cold, "rounds": rounds,
               **bound_entry(nbytes)}
        result["by"][key] = row
        print(f"[{label}] (12d) id kernel {key} ({'wide' if tab.wide else 'narrow'}, "
              f"{'16' if u16 else '32'}-bit out): packed prefix of {read} entries equal to the twin "
              f"(max_abs_err 0, tolerance 0), one launch, no host sync, {merged} rows merged, "
              f"{rounds} rounds; kernel {k1:.4f} / {k2:.4f} ms ({row['ms'] / rounds * 1e3:.3f} us a "
              f"round), cold L2 {cold:.4f} ms ({cold / rounds * 1e3:.3f} us a round); twin "
              f"{p1:.3f} ms; bound {row['bound_ms']:.5f} ms ({nbytes} B), share "
              f"{row['bound_ms'] / row['ms']:.3f}", flush=True)
    return result


def char_and_long_words(device: str, zipf: list[str], unique: list[str], label: str,
                        wide: dict, directory: str):
    """Phase 12: char mode and words of 33-128 bytes through the id merge
    kernel.  Returns (its launches over the runs of (b) and (c), by run,
    (d)'s result)."""
    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.tables import device_tables, max_token_id

    t0 = time.perf_counter()
    vocab, special = write_char_fixture(os.path.join(directory, "char"))
    char_ctx = TokenizerContext.load(vocab, special, is_byte_encoder=False)
    char = (vocab, special, None)
    check(len(char_ctx.vocab.id2str) == 32000 and max_token_id(char_ctx.vocab) < 0xFFFF,
          "(12a) the char-mode vocabulary: 32,000 ids below 0xFFFF")
    print(f"(12a) char-mode vocabulary written and loaded in {time.perf_counter() - t0:.1f} s", flush=True)
    long_docs = long_word_docs(zipf)
    runs = [
        ("char       zipf   no prefix", char, False, None, zipf, "auto", "char"),
        ("char       unique no prefix", char, False, None, unique, "auto", "char"),
        (f"char       zipf {CHAR_PREFIX_MB:g} MB prefix ▁", char, False, "▁",
         docs_mb(zipf, CHAR_PREFIX_MB), "auto", "char"),
        ("big-merges long words RAW=0", fixture_paths("big-merges"), True, None, long_docs, "0", "long"),
        ("wide-merges long words RAW=0", wide["wide-merges"], True, None, long_docs, "0", "long-wide"),
    ]
    by_run = id_runs(device, runs, label)
    launches = sum(c["id_merge"] + c["id_merge_wide"] for c in by_run.values())
    per_run = {name: c["id_merge"] + c["id_merge_wide"] for name, c in by_run.items()}

    t0 = time.perf_counter()
    tables = {}
    for name in ("big-merges", "wide-merges"):
        ctx, enc = load_config(fixture_paths(name) if name == "big-merges" else wide[name])
        tables[name] = (device_tables(enc, ctx, device), enc.pairs)
    check(tables["wide-merges"][0].wide and not tables["big-merges"][0].wide, "(12d) the tables' layouts")
    result = id_vs_plain(device, zipf, unique, label, char_ctx, tables)
    print(f"(12d) kernel against twin: sub-phase {time.perf_counter() - t0:.1f} s", flush=True)
    return launches, per_run, result


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = "cuda"

    # 1. device
    label = card_label()
    print(label)
    from hutoken_tpu_torch.native import load_native

    native = load_native() is not None
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, native host library loaded: {native}")
    check(native, "native host library (make -C native)")

    # 2. build: one nvcc per kernel source, started together
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import gather as G
    from hutoken_tpu_torch.ops import id_merge as IM
    from hutoken_tpu_torch.ops import seg_merge as SM

    t0 = time.perf_counter()
    with ThreadPoolExecutor(4) as pool:
        built = list(pool.map(lambda m: m.build(), (FM, SM, G, IM)))
    for so in built:
        print(f"built {os.path.relpath(so, HERE)}")
    print(f"all four kernel sources built in {time.perf_counter() - t0:.1f} s")

    t0 = time.perf_counter()
    zipf = build_corpus(ZIPF_MB)
    unique = build_unique_corpus(UNIQUE_MB)
    print(f"corpora built in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain
    kv = fused_vs_plain(device, unique, label,
                        {n: fixture_paths(n) for n in ("small", "big-vocab", "big-merges")})
    sv = seg_vs_plain(device, unique, zipf, label)

    # 4. gather probe; counts are zeroed inside, right before the run
    t0 = time.perf_counter()
    gathers = gather_probe(device, label)
    print(f"gather probe took {time.perf_counter() - t0:.1f} s")

    # 5. main path; counts are zeroed inside, right before each run
    launches, per_run = main_path(device, zipf, unique, label)
    check(launches["fused_merge"] > 0 and launches["seg_merge"] > 0 and not launches["fused_merge_wide"],
          f"the main path launched both narrow kernels and not the wide one: {launches}")

    # 6. device decode
    t0 = time.perf_counter()
    device_decode(device, zipf, unique, label)
    print(f"device decode took {time.perf_counter() - t0:.1f} s")

    # 6w. the wide vocabulary (its files kept for phase 12); counts are
    # zeroed inside, right before each run
    t0 = time.perf_counter()
    generated = tempfile.TemporaryDirectory(prefix="hutoken-fixtures-")
    wide = wide_paths(os.path.join(generated.name, "wide"))
    kvw = fused_vs_plain(device, zipf, label, wide)
    wide_launches, wide_per_run = wide_main_path(device, zipf, unique, label, wide)
    check(wide_launches > 0, "the wide main path launched the wide kernel")
    print(f"wide vocabulary phases took {time.perf_counter() - t0:.1f} s")

    # 7. profile
    profile_runs(device, unique, label)

    # 8. device training
    t0 = time.perf_counter()
    device_training(label)
    print(f"device training took {time.perf_counter() - t0:.1f} s")

    # 9. device string training
    t0 = time.perf_counter()
    string_training(label)
    print(f"device string training took {time.perf_counter() - t0:.1f} s")

    # 10. sharded encode and training across processes; counts are zeroed
    # inside, right before each sharded run
    t0 = time.perf_counter()
    mesh_launches = sharded_encode(device, zipf, unique, label)
    print(f"sharded encode took {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    multi_process_training(device, label)
    print(f"multi-process training took {time.perf_counter() - t0:.1f} s")

    # 11. the 16-bit repair's vocabularies, then the drivers; counts are
    # zeroed inside, right before each
    t0 = time.perf_counter()
    hole_vocabularies(device, label)
    drivers(label)
    print(f"drivers took {time.perf_counter() - t0:.1f} s")

    # 12. char mode and long words through the id merge kernel; counts are
    # zeroed inside, right before each run
    t0 = time.perf_counter()
    id_launches, id_per_run, iv = char_and_long_words(device, zipf, unique, label, wide, generated.name)
    generated.cleanup()
    print(f"char mode and long words took {time.perf_counter() - t0:.1f} s")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hutoken_tpu"))
    check(not loaded, f"neither jax nor the JAX package was loaded: {loaded[:5]}")
    print("neither jax nor hutoken_tpu is in sys.modules")

    fused_src = "hutoken_tpu_torch/csrc/fused_merge.cu"
    print(json.dumps({"kernels": [
        {**merge_entry("fused_merge", fused_src, "hutoken_tpu/ops/pallas_merge.py:252",
                       launches["fused_merge"], per_run["fused_merge"], kv, "big-merges L=32", "block"),
         "launches_per_shard_mesh4": {k: v for k, v in mesh_launches.items() if "wide" not in k}},
        {"variant": "wide", **merge_entry(
            "fused_merge", fused_src, "hutoken_tpu/ops/rmatrix.py:231",
            wide_launches, wide_per_run, kvw, "wide-merges L=32", "block"),
         "launches_per_shard_mesh4": {k: v for k, v in mesh_launches.items() if "wide" in k}},
        merge_entry("seg_merge", "hutoken_tpu_torch/csrc/seg_merge.cu",
                    "hutoken_tpu/ops/pallas_merge.py:445", launches["seg_merge"],
                    per_run["seg_merge"], sv, "big-merges", "table"),
        merge_entry("id_merge", "hutoken_tpu_torch/csrc/id_merge.cu", "hutoken_tpu/ops/merge.py:247",
                    id_launches, id_per_run, iv, "char 16384x32", "block"),
        *gathers,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--peer"]:
        sys.exit(peer(sys.argv[2:]))
    sys.exit(main())
