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
2. build: compiles the three kernel sources of ``hutoken_tpu_torch/csrc``
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
4. gather probe: ``hutoken_tpu_torch.profile_gather`` at every shape of
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
   through ``encode_batch_arrays``.

The last two lines are the kernel summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from hutoken_tpu_torch.corpora import build_corpus, build_unique_corpus, write_wide_fixture  # noqa: E402

ZIPF_MB = 24
UNIQUE_MB = 8
BLOCK_WORDS = 16384  # ROW_BLOCKS[32] of the port's engine
CHECK_WORDS = 12345  # odd on purpose: the kernel takes any word count
ORACLE_SAMPLE = 40
RAW_CHUNK = 1 << 22  # HUTOKEN_TPU_RAW_C's default: the raw path's chunk bytes
MIXED_WORDS = 40000  # words per mixed check chunk
LENGTH_RUNS = 2000  # 32-word runs in the every-length chunk
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
FIXTURES = os.path.join(HERE, "tests", "fixtures")

# ------------------------------------------------------------- inputs


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def fixture_paths(name: str):
    """(vocab, special chars, merges or None) of a committed fixture."""
    stem = "bytelevel" if name == "small" else "bigvocab"
    vocab = os.path.join(FIXTURES, f"{stem}-vocab.txt")
    special = os.path.join(FIXTURES, f"{stem}-vocab_special_chars.txt")
    merges = os.path.join(FIXTURES, "bigvocab-merges.txt") if name == "big-merges" else None
    for p in (vocab, special, merges):
        check(p is None or os.path.isfile(p), f"fixture file {p} is committed")
    return vocab, special, merges


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


def kernel_ms(fn) -> float:
    """Device ms per call, with a sleep queued ahead so that the host's
    enqueue never paces the loop (``profile_gather.cuda_time``)."""
    from hutoken_tpu_torch import profile_gather as PG

    return PG.cuda_time(fn)


@contextlib.contextmanager
def probe_log():
    """Record every (left, right) pair the plain twins probe."""
    from hutoken_tpu_torch.ops import fused_merge as FM

    pairs = []
    real = FM.probe_pairs

    def logged(tab, a, b):
        pairs.append((a.reshape(-1), b.reshape(-1)))
        return real(tab, a, b)

    FM.probe_pairs = logged
    try:
        yield pairs
    finally:
        FM.probe_pairs = real


def probed_slot_bytes(tab, pairs) -> int:
    """Pair-table bytes that the merge must read for these pairs, counted
    over the distinct slots the probe visits (from the hash slot up to
    the hit or the first empty slot).  Narrow table: a 4-byte key per
    visited slot, a 4-byte value per hit slot and, with a minsuper bound,
    4 bytes per distinct hit rank; the kernel's 16-byte interleaved slot
    is its own choice, not the function's need.  Wide table: a whole
    16-byte slot per visited slot, since its key is both 32-bit ids."""
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
    if tab.minsuper is not None:
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
    from hutoken_tpu_torch.tables import device_tables

    rng = np.random.default_rng(0)
    result = {"max_abs_err": 0, "by": {}}
    for name, paths in configs.items():
        ctx, enc = load_config(paths)
        tab = device_tables(enc, ctx, device)
        u16 = enc.vocab_size < 0xFFFF
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
            k1 = kernel_ms(lambda: FM.merge_words_from_bytes_fused(tab, r, n, u16))
            c1 = time_ms(lambda: compact_output(ids, u16), 10)
            k2 = kernel_ms(lambda: FM.merge_words_from_bytes_fused(tab, r, n, u16))
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


def raw_chunk(docs: list[str]):
    """The unique corpus's first raw-path chunk: whole documents up to
    RAW_CHUNK bytes, as the engine's producer fills one."""
    blobs, size = [], 0
    for d in docs:
        b = d.encode()
        if size + len(b) > RAW_CHUNK:
            break
        blobs.append(b)
        size += len(b)
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
        k1 = kernel_ms(lambda: SM.seg_merge(tab, *args))
        k2 = kernel_ms(lambda: SM.seg_merge(tab, *args))
        row = {"ms": (k1 + k2) / 2, "plain_ms": p1, **bound_entry(nbytes)}
        result["by"][name] = row
        print(f"[{label}] seg merge {name:10s} raw chunk {n} B, {args[1].shape[0]} words: "
              f"kernel {k1:.4f} / {k2:.4f} ms; twin {p1:.3f} ms; bound "
              f"{row['bound_ms']:.5f} ms ({nbytes} B), share {row['bound_ms'] / row['ms']:.3f}")
    return result


# ------------------------------------------------------- phases 4 to 7


def launch_counts() -> dict:
    """The encode kernels' launch counts (narrow fused, wide fused, seg)."""
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import seg_merge as SM

    f = FM.merge_words_from_bytes_fused
    return {"fused_merge": f.launches, "fused_merge_wide": f.wide_launches,
            "seg_merge": SM.seg_merge.launches}


def zero_launch_counts() -> None:
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import seg_merge as SM

    f = FM.merge_words_from_bytes_fused
    f.launches = f.wide_launches = SM.seg_merge.launches = 0


def encode_run(native, docs: list[str], what: str, want_path: str, label: str):
    """One main-path run through the initialized facade: a checked run,
    then a timed cold one, the counts zeroed right before each and read
    right after.  ``want_path`` is the path it must take: "raw" (the
    segmented kernel), "pipeline" (the fused kernel) or "wide" (the wide
    fused kernel).  ``native`` is the native engine of the same
    configuration.  Returns (ids per document, the cold run's launch
    counts, the largest id)."""
    import torch

    import hutoken_tpu_torch as hutoken
    from hutoken_tpu_torch import oracle

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
    check(counts == first, f"{what}: a cold run launches as the first run did ({counts} vs {first})")
    share = (engine.stat_device_bytes - dev0) / nbytes
    fused, wide, seg = counts["fused_merge"], counts["fused_merge_wide"], counts["seg_merge"]
    if want_path == "raw":
        check(seg > 0, f"{what}: the raw path never launched the segmented kernel")
        check(share > 0.9, f"{what}: only {share:.4f} of the bytes reached the device")
        check(engine.stat_host_cause.get("raw_host_chunk", 0) == 0, f"{what}: a chunk went to the host")
    elif want_path == "wide":
        check(wide > 0 and fused == 0 and seg == 0, f"{what}: the wide kernel alone must run: {counts}")
    else:
        check(fused > 0 and wide == 0 and seg == 0, f"{what}: the word pipeline did not run the fused kernel")
    core = "raw" if want_path == "raw" else ("pipelined" if engine._native_split_ok else "python")
    print(f"[{label}] main path {what}: {nbytes / 1e6:.1f} MB, "
          f"{len(docs)} docs: equal to native (all docs) and oracle ({ORACLE_SAMPLE}); "
          f"{core} core; cold run {nbytes / 1e6 / dt:.2f} MB/s ({dt:.3f} s); "
          f"device byte share {share:.4f}; launches per run fused {fused}, wide {wide}, seg {seg}; "
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
    launches = {"fused_merge": 0, "fused_merge_wide": 0, "seg_merge": 0}
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
    from hutoken_tpu_torch import profile_gather as PG
    from hutoken_tpu_torch.ops import gather as G

    empty_ms = PG.empty_launch_ms()
    print(f"[{label}] empty launch (torch.cuda._sleep(0)) {empty_ms:.4f} ms")
    G.reset_launches()
    rows = PG.run(device, timer=PG.cuda_time, label=label)
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
    }


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = "cuda"

    # 1. device
    from hutoken_tpu_torch.profile_gather import card_label

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
    from hutoken_tpu_torch.ops import seg_merge as SM

    t0 = time.perf_counter()
    with ThreadPoolExecutor(3) as pool:
        built = list(pool.map(lambda m: m.build(), (FM, SM, G)))
    for so in built:
        print(f"built {os.path.relpath(so, HERE)}")
    print(f"all three kernel sources built in {time.perf_counter() - t0:.1f} s")

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

    # 6w. the wide vocabulary; counts are zeroed inside, right before each run
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="hutoken-wide-") as wide_dir:
        wide = wide_paths(wide_dir)
        kvw = fused_vs_plain(device, zipf, label, wide)
        wide_launches, wide_per_run = wide_main_path(device, zipf, unique, label, wide)
    check(wide_launches > 0, "the wide main path launched the wide kernel")
    print(f"wide vocabulary phases took {time.perf_counter() - t0:.1f} s")

    # 7. profile
    profile_runs(device, unique, label)
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "hutoken_tpu"))
    check(not loaded, f"neither jax nor the JAX package was loaded: {loaded[:5]}")
    print("neither jax nor hutoken_tpu is in sys.modules")

    fused_src = "hutoken_tpu_torch/csrc/fused_merge.cu"
    print(json.dumps({"kernels": [
        merge_entry("fused_merge", fused_src, "hutoken_tpu/ops/pallas_merge.py:252",
                    launches["fused_merge"], per_run["fused_merge"], kv, "big-merges L=32", "block"),
        {"variant": "wide", **merge_entry(
            "fused_merge", fused_src, "hutoken_tpu/ops/rmatrix.py:231",
            wide_launches, wide_per_run, kvw, "wide-merges L=32", "block")},
        merge_entry("seg_merge", "hutoken_tpu_torch/csrc/seg_merge.cu",
                    "hutoken_tpu/ops/pallas_merge.py:445", launches["seg_merge"],
                    per_run["seg_merge"], sv, "big-merges", "table"),
        *gathers,
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
