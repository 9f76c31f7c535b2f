#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

It imports nothing of JAX.  Phases, each failing the run on its own:

1. device: the card's name and power limit, torch and CUDA versions,
   and whether the native host library loaded;
2. build: compiles the three kernel sources of ``hutoken_tpu_torch/csrc``
   (one ``nvcc`` each, started together);
3. kernel vs plain, on the same CUDA tensors, exact equality:
   the fused merge for the small, big-vocab and big-merges tables at
   widths 8, 16 and 32, timed at the word pipeline's block shape
   (16,384 words x 32 bytes); the segmented merge on mixed chunks
   (ASCII, Hungarian accents, words of 1-32 and over 32 bytes, document
   resets) for the same tables, timed on one raw-path chunk
   (``HUTOKEN_TPU_RAW_C``, 4 MB) of the unique corpus;
4. gather probe: ``hutoken_tpu_torch.profile_gather`` at every shape of
   the three TPU gather-profiling scripts, each gather kernel equal to
   its twin (tolerance 0), kernel and twin times and M lookups/s;
5. main path: the facade's ``initialize`` + ``batch_encode`` on the
   committed 23,096-id fixture (merges.txt and string-path configs)
   over a 24 MB Zipf corpus and an 8 MB high-entropy corpus.  Under
   ``HUTOKEN_TPU_RAW=auto`` the unique runs must take the raw path
   (segmented kernel launched, nearly every byte on the device) and the
   Zipf runs the word pipeline (fused kernel launched); big-merges /
   unique runs once more with ``HUTOKEN_TPU_RAW=0``.  Every document
   must equal the native host engine, a sample the scalar oracle; a
   cold run's MB/s and the share of corpus bytes sent to the device
   print beside the card's name and power limit; a sample round-trips
   through ``batch_decode``;
6. device decode: the facade with ``backend="device"`` decodes the ids
   of both corpora under both configs; every document must equal the
   native decode and the original text, the device path must have run,
   and decode MB/s prints beside the native host decode's; the engine's
   ``decode_arrays_device`` must return a CUDA blob equal byte for byte
   to the native ``decode_arrays``;
6w. the generated 100,256-id vocabulary
   (``tests/torch_parity.py::write_wide_fixture``, string and merges
   paths, written to a temporary directory): the wide fused kernel
   against its twin as in phase 3, on Zipf corpus words (which must give
   ids of 0x10000 or more); then one facade ``initialize``
   (``backend="device"``) per configuration; ``batch_encode`` of both
   corpora under ``HUTOKEN_TPU_RAW=auto`` must take the word pipeline
   with the wide kernel (never the raw path: the JAX engine has none for
   such a vocabulary) and equal the native engine on every document and
   the oracle on a sample, and the two runs must hold ids of 0x10000 or
   more between them (the unique corpus's random identifiers do not
   reach them); then device decode of the same ids as in phase 6;
7. profile: one more cold run of big-merges / unique on each encode path
   under ``torch.profiler``: the device busy share, the top kernels, and
   the run's wall through ``encode_batch_arrays`` (no per-document lists).

The last two lines are the kernel summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

ZIPF_MB = 24
UNIQUE_MB = 8
BLOCK_WORDS = 16384  # ROW_BLOCKS[32] of the port's engine
CHECK_WORDS = 12345  # odd on purpose: the kernel takes any word count
ORACLE_SAMPLE = 40
RAW_CHUNK = 1 << 22  # HUTOKEN_TPU_RAW_C's default: the raw path's chunk bytes
MIXED_WORDS = 40000  # words per mixed check chunk
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def fixture_paths(name: str):
    """(vocab, special chars, merges or None) of a committed fixture."""
    import fixture_tools as ft

    if name == "small":
        return (*ft.write_byte_level_fixture(), None)
    merges = ft.write_big_merges_fixture() if name == "big-merges" else None
    return (*ft.write_big_vocab_fixture(), merges)


def wide_paths(directory: str) -> dict:
    """Write the generated 100,256-id vocabulary into ``directory``;
    returns config name -> (vocab, special chars, merges or None)."""
    import torch_parity as tp

    vocab, special, merges = tp.write_wide_fixture(directory)
    return {"wide-string": (vocab, special, None), "wide-merges": (vocab, special, merges)}


def load_config(paths):
    """(TokenizerContext, EncoderTables) of (vocab, special, merges)."""
    from hutoken_tpu.context import TokenizerContext
    from hutoken_tpu.tables import build_encoder_tables

    vocab, special, merges = paths
    ctx = TokenizerContext.load(vocab, special, is_byte_encoder=True, merges_file_path=merges)
    return ctx, build_encoder_tables(ctx)


def random_block(rng, n: int, width: int):
    """ASCII and high bytes, lengths 0..width."""
    alphabet = np.frombuffer(HIGH_BYTES, dtype=np.uint8)
    lens = rng.integers(0, width + 1, n).astype(np.int32)
    raw = alphabet[rng.integers(0, len(alphabet), (n, width))]
    ascii_rows = rng.random(n) < 0.5
    raw[ascii_rows] = rng.integers(ord("a"), ord("z") + 1, (int(ascii_rows.sum()), width))
    raw[np.arange(width)[None, :] >= lens[:, None]] = 0
    return raw, lens


def corpus_block(docs: list[str], rng, n: int, width: int):
    """``n`` distinct corpus words of 2..width bytes, length-sorted as the
    engine packs them."""
    seen = set()
    for d in docs[:4000]:
        for w in d.split(" "):
            b = (" " + w).encode()
            if 2 <= len(b) <= width:
                seen.add(b)
    words = sorted(seen)
    pick = sorted((words[i] for i in rng.choice(len(words), n, replace=len(words) < n)), key=len)
    raw = np.zeros((n, width), dtype=np.uint8)
    lens = np.array([len(w) for w in pick], dtype=np.int32)
    for i, w in enumerate(pick):
        raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    return raw, lens


def time_ms(fn, reps: int) -> float:
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


def kernel_vs_plain(device: str, docs: list[str], label: str, configs: dict) -> dict:
    """Phase 3: kernel == twin on the card for each of ``configs`` (name
    -> paths; all narrow or all wide, the variant each launches); times
    at the block shape.  A wide table's corpus words must give ids of
    0x10000 or more."""
    import torch

    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.tables import device_tables

    rng = np.random.default_rng(0)
    result = {"max_abs_err": 0, "ms": {}, "plain_ms": {}}
    for name, paths in configs.items():
        ctx, enc = load_config(paths)
        tab = device_tables(enc, ctx, device)
        check(tab.wide == name.startswith("wide-"), f"{name}: the table's layout")
        for width in (8, 16, 32):
            raw, lens = random_block(rng, CHECK_WORDS, width)
            r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
            ids, counts = FM.fused_merge(tab, r, n)
            pids, pcounts = FM.fused_merge_plain(tab, r, n)
            err = max(
                int((ids - pids).abs().max()), int((counts - pcounts).abs().max())
            )
            result["max_abs_err"] = max(result["max_abs_err"], err)
            merged = int((counts < n).sum())
            print(f"kernel vs plain  {name:11s} W={CHECK_WORDS} L={width}: "
                  f"max_abs_err={err} (tolerance 0), words merged={merged}, "
                  f"max id {int(ids.max())}")
            check(err == 0, f"kernel == plain twin ({name}, L={width})")
        raw, lens = corpus_block(docs, rng, BLOCK_WORDS, 32)
        r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
        ids, counts = FM.fused_merge(tab, r, n)
        check(
            all(torch.equal(a, b) for a, b in zip((ids, counts), FM.fused_merge_plain(tab, r, n))),
            f"kernel == plain twin on corpus words ({name})",
        )
        if tab.wide:
            check(int(ids.max()) >= 0x10000, f"{name}: corpus words give ids of 0x10000 or more")
        # plain, kernel, kernel, plain; the pair table is meant to stay in
        # L2, so launches are not separated by a cache flush
        p1 = time_ms(lambda: FM.fused_merge_plain(tab, r, n), 3)
        k1 = time_ms(lambda: FM.fused_merge(tab, r, n), 50)
        k2 = time_ms(lambda: FM.fused_merge(tab, r, n), 50)
        p2 = time_ms(lambda: FM.fused_merge_plain(tab, r, n), 3)
        result["ms"][name] = (k1 + k2) / 2
        result["plain_ms"][name] = (p1 + p2) / 2
        print(f"[{label}] fused merge {name:11s} {BLOCK_WORDS}x32 corpus words: "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.3f} / {p2:.3f} ms")
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


def seg_kernel_vs_plain(device: str, docs: list[str], label: str) -> dict:
    """Phase 3, segmented merge: kernel == twin on the card; times on
    one raw-path chunk of the unique corpus."""
    import torch

    from hutoken_tpu_torch.ops import seg_merge as SM
    from hutoken_tpu_torch.ops import split as S
    from hutoken_tpu_torch.tables import device_tables

    rng = np.random.default_rng(2)
    result = {"max_abs_err": 0, "ms": {}, "plain_ms": {}}
    big = raw_chunk(docs)
    for name in ("small", "big-vocab", "big-merges"):
        ctx, enc = load_config(fixture_paths(name))
        tab = device_tables(enc, ctx, device)
        chunk, ends = mixed_chunk(rng, MIXED_WORDS)
        check(S.supported_alphabet(chunk), "mixed chunk is in the device alphabet")
        args = seg_inputs(device, chunk, ends)
        ids, pids = SM.seg_merge(tab, *args), SM.seg_merge_plain(tab, *args)
        err = int((ids - pids).abs().max())
        result["max_abs_err"] = max(result["max_abs_err"], err)
        print(f"seg kernel vs plain {name:10s} {chunk.shape[0]} B, {len(ends)} docs, "
              f"{int((args[2] > 0).sum())} words <= 32 B of {args[1].shape[0]}: max_abs_err={err} (tolerance 0), "
              f"tokens={int((ids >= 0).sum())}")
        check(err == 0, f"seg kernel == plain twin ({name})")
        args = seg_inputs(device, *big)
        check(torch.equal(SM.seg_merge(tab, *args), SM.seg_merge_plain(tab, *args)),
              f"seg kernel == plain twin on a raw chunk ({name})")
        # plain, kernel, kernel, plain; the table stays in L2 as in a run
        p1 = time_ms(lambda: SM.seg_merge_plain(tab, *args), 2)
        k1 = time_ms(lambda: SM.seg_merge(tab, *args), 20)
        k2 = time_ms(lambda: SM.seg_merge(tab, *args), 20)
        p2 = time_ms(lambda: SM.seg_merge_plain(tab, *args), 2)
        result["ms"][name] = (k1 + k2) / 2
        result["plain_ms"][name] = (p1 + p2) / 2
        print(f"[{label}] seg merge {name:10s} raw chunk {big[0].shape[0]} B, "
              f"{args[1].shape[0]} words: kernel {k1:.4f} / {k2:.4f} ms, "
              f"plain twin {p1:.3f} / {p2:.3f} ms")
    return result


def launch_counts() -> dict:
    """The encode kernels' launch counts (narrow fused, wide fused, seg)."""
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import seg_merge as SM

    return {"fused_merge": FM.fused_merge.launches,
            "fused_merge_wide": FM.fused_merge.wide_launches,
            "seg_merge": SM.seg_merge.launches}


def zero_launch_counts() -> None:
    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.ops import seg_merge as SM

    FM.fused_merge.launches = FM.fused_merge.wide_launches = SM.seg_merge.launches = 0


def encode_run(native, docs: list[str], what: str, want_path: str, label: str):
    """One main-path run through the initialized facade: a checked run,
    then a timed cold one, the counts zeroed right before each and read
    right after.  ``want_path`` is the path it must take: "raw" (the
    segmented kernel), "pipeline" (the fused kernel) or "wide" (the wide
    fused kernel).  ``native`` is the native engine of the same
    configuration.  Returns (ids per document, summed launch counts, the
    largest id)."""
    import torch

    import hutoken_tpu_torch as hutoken
    from hutoken_tpu import oracle

    engine = hutoken._get_engine()
    nbytes = sum(len(d.encode()) for d in docs)
    zero_launch_counts()
    got = hutoken.batch_encode(docs)
    counts = launch_counts()
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
    counts = {k: v + launch_counts()[k] for k, v in counts.items()}
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
          f"device byte share {share:.4f}; launches fused {fused}, wide {wide}, seg {seg}; "
          f"max id {max_id}; host bytes by cause {engine.stat_host_cause}")
    return got, counts, max_id


def main_path(device: str, zipf: list[str], unique: list[str], label: str) -> dict:
    """Phase 5 through the facade; returns each kernel's launches."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu.native import NativeEngine

    # (config, corpus name, docs, HUTOKEN_TPU_RAW, path it must take)
    runs = [
        ("big-merges", "zipf", zipf, "auto", "pipeline"),
        ("big-merges", "unique", unique, "auto", "raw"),
        ("big-merges", "unique", unique, "0", "pipeline"),
        ("big-vocab", "zipf", zipf, "auto", "pipeline"),
        ("big-vocab", "unique", unique, "auto", "raw"),
    ]
    launches = {"fused_merge": 0, "fused_merge_wide": 0, "seg_merge": 0}
    for config, cname, docs, raw_env, want_path in runs:
        os.environ["HUTOKEN_TPU_RAW"] = raw_env
        vocab, special, merges = fixture_paths(config)
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=True, device=device, **kw)
        _got, counts, _max_id = encode_run(NativeEngine(hutoken._ctx), docs,
                                  f"{config:10s} {cname:6s} RAW={raw_env:4s}", want_path, label)
        for k, v in counts.items():
            launches[k] += v
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return launches


def wide_main_path(device: str, zipf: list[str], unique: list[str], label: str,
                   configs: dict) -> int:
    """Phase 6w: one facade per wide configuration, both corpora encoded
    under ``HUTOKEN_TPU_RAW=auto`` (the word pipeline with the wide
    kernel), then their ids decoded on the device; returns the wide
    kernel's launches."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu.native import NativeEngine

    launches = 0
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
            max_ids.append(max_id)
            decode_run(native, docs, ids, f"{config:11s} {cname:6s}", label)
        # the unique corpus's random identifiers stay below 0x10000 here
        check(max(max_ids) >= 0x10000, f"{config}: no id of 0x10000 or more")
    os.environ.pop("HUTOKEN_TPU_RAW", None)
    return launches


def gather_probe(device: str, label: str) -> list[dict]:
    """Phase 4: the gather probe at every shape of the three scripts, its
    kernels' counts zeroed right before and read right after.  Returns
    one kernels-line entry per TPU kernel: the worst error over its
    shapes, the times at the largest shape of its Pallas loop."""
    from hutoken_tpu_torch import profile_gather as PG
    from hutoken_tpu_torch.ops import gather as G

    G.reset_launches()
    rows = PG.run(device, timer=PG.cuda_time, label=label)
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
            "max_abs_err": max(r["max_abs_err"] for r in mine),
            "ms": main["ms"],
            "plain_ms": main["plain_ms"],
            "shape": main["case"],
            "ms_by_shape": {r["case"]: r["ms"] for r in mine},
            "plain_ms_by_shape": {r["case"]: r["plain_ms"] for r in mine},
        }
        if mode:
            entry["variant"] = mode
        entries.append(entry)
    return entries


def device_decode(device: str, zipf: list[str], unique: list[str], label: str) -> None:
    """Phase 6: device decode through the facade (``backend="device"``)
    of both corpora's native ids under both committed configurations."""
    import hutoken_tpu_torch as hutoken
    from hutoken_tpu.native import NativeEngine

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
    and the same run's wall through ``encode_batch_arrays``."""
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
        # device-side events only: an operator's row repeats its kernels' time
        rows = [(e.self_device_time_total, e.key) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
        busy = sum(t for t, _k in rows) / 1e6
        top = ", ".join(f"{k[:40]} {t / 1e3:.2f} ms" for t, k in sorted(rows, reverse=True)[:6] if t > 0)
        # the same cold run through the arrays API: no per-document lists
        hutoken._get_engine().reset_cache()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hutoken._get_engine().encode_batch_arrays(unique)
        torch.cuda.synchronize()
        arrays = time.perf_counter() - t0
        print(f"[{label}] profile big-merges unique RAW={raw_env}: wall {wall:.3f} s, "
              f"device self time {busy:.4f} s, busy share {busy / wall:.4f}; "
              f"arrays API cold {arrays:.3f} s; top: {top}")
    os.environ.pop("HUTOKEN_TPU_RAW", None)


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
    from hutoken_tpu.native import load_native

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

    import bench

    t0 = time.perf_counter()
    zipf = bench.build_corpus(ZIPF_MB)
    unique = bench.build_unique_corpus(UNIQUE_MB)
    print(f"corpora built in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain
    kv = kernel_vs_plain(device, unique, label,
                         {n: fixture_paths(n) for n in ("small", "big-vocab", "big-merges")})
    sv = seg_kernel_vs_plain(device, unique, label)

    # 4. gather probe; counts are zeroed inside, right before the run
    t0 = time.perf_counter()
    gathers = gather_probe(device, label)
    print(f"gather probe took {time.perf_counter() - t0:.1f} s")

    # 5. main path; counts are zeroed inside, right before each run
    launches = main_path(device, zipf, unique, label)
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
        kvw = kernel_vs_plain(device, zipf, label, wide)
        wide_launches = wide_main_path(device, zipf, unique, label, wide)
    check(wide_launches > 0, "the wide main path launched the wide kernel")
    print(f"wide vocabulary phases took {time.perf_counter() - t0:.1f} s")

    # 7. profile
    profile_runs(device, unique, label)
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax stayed unloaded")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": [
        {
            "name": "fused_merge",
            "route": "cuda",
            "source": "hutoken_tpu_torch/csrc/fused_merge.cu",
            "replaces": "hutoken_tpu/ops/pallas_merge.py:252",
            "launches": launches["fused_merge"],
            "max_abs_err": kv["max_abs_err"],
            "ms": kv["ms"]["big-merges"],
            "plain_ms": kv["plain_ms"]["big-merges"],
            "ms_by_table": kv["ms"],
            "plain_ms_by_table": kv["plain_ms"],
        },
        {
            "name": "fused_merge",
            "variant": "wide",
            "route": "cuda",
            "source": "hutoken_tpu_torch/csrc/fused_merge.cu",
            "replaces": "hutoken_tpu/ops/rmatrix.py:231",
            "launches": wide_launches,
            "max_abs_err": kvw["max_abs_err"],
            "ms": kvw["ms"]["wide-merges"],
            "plain_ms": kvw["plain_ms"]["wide-merges"],
            "ms_by_table": kvw["ms"],
            "plain_ms_by_table": kvw["plain_ms"],
        },
        {
            "name": "seg_merge",
            "route": "cuda",
            "source": "hutoken_tpu_torch/csrc/seg_merge.cu",
            "replaces": "hutoken_tpu/ops/pallas_merge.py:445",
            "launches": launches["seg_merge"],
            "max_abs_err": sv["max_abs_err"],
            "ms": sv["ms"]["big-merges"],
            "plain_ms": sv["plain_ms"]["big-merges"],
            "ms_by_table": sv["ms"],
            "plain_ms_by_table": sv["plain_ms"],
        },
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
