#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one CUDA device

It imports nothing of JAX.  Phases, each failing the run on its own:

1. device: the card's name and power limit, torch and CUDA versions,
   and whether the native host library loaded;
2. build: compiles the fused merge kernel from ``hutoken_tpu_torch/csrc``;
3. kernel vs plain: the CUDA kernel against its plain PyTorch twin on
   the same CUDA tensors, for the small, big-vocab and big-merges tables
   at widths 8, 16 and 32 (exact equality), then both timed at the main
   path's block shape (16,384 words x 32 bytes);
4. main path: the facade's ``initialize`` + ``batch_encode`` on the
   committed 23,096-id fixture, over a 24 MB Zipf corpus and an 8 MB
   high-entropy corpus (merges.txt config) and the Zipf corpus (string
   path config).  Every document must equal the native host engine, a
   sample the scalar oracle; the kernel's launch count must rise; a cold
   run's MB/s and the share of corpus bytes sent to the device print
   beside the card's name and power limit; a sample round-trips through
   ``batch_decode``.

The last two lines are the kernel summary and ``{"ok": true, ...}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.join(HERE, "tests"))

ZIPF_MB = 24
UNIQUE_MB = 8
BLOCK_WORDS = 16384  # ROW_BLOCKS[32] of the port's engine
CHECK_WORDS = 12345  # odd on purpose: the kernel takes any word count
ORACLE_SAMPLE = 40
HIGH_BYTES = bytes(range(0x20, 0x7F)) + bytes(range(0x80, 0x100))


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def card_label() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout
    return out.strip().splitlines()[0]


def fixture_paths(name: str):
    """(vocab, special chars, merges or None) of a committed fixture."""
    import fixture_tools as ft

    if name == "small":
        return (*ft.write_byte_level_fixture(), None)
    merges = ft.write_big_merges_fixture() if name == "big-merges" else None
    return (*ft.write_big_vocab_fixture(), merges)


def load_config(name: str):
    """(TokenizerContext, EncoderTables) of a fixture configuration."""
    from hutoken_tpu.context import TokenizerContext
    from hutoken_tpu.tables import build_encoder_tables

    vocab, special, merges = fixture_paths(name)
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


def kernel_vs_plain(device: str, docs: list[str], label: str) -> dict:
    """Phase 3: kernel == twin on the card; times at the block shape."""
    import torch

    from hutoken_tpu_torch.ops import fused_merge as FM
    from hutoken_tpu_torch.tables import device_tables

    rng = np.random.default_rng(0)
    result = {"max_abs_err": 0, "ms": {}, "plain_ms": {}}
    for name in ("small", "big-vocab", "big-merges"):
        ctx, enc = load_config(name)
        tab = device_tables(enc, ctx, device)
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
            print(f"kernel vs plain  {name:10s} W={CHECK_WORDS} L={width}: "
                  f"max_abs_err={err} (tolerance 0), words merged={merged}")
            check(err == 0, f"kernel == plain twin ({name}, L={width})")
        raw, lens = corpus_block(docs, rng, BLOCK_WORDS, 32)
        r, n = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
        check(
            all(torch.equal(a, b) for a, b in zip(FM.fused_merge(tab, r, n), FM.fused_merge_plain(tab, r, n))),
            f"kernel == plain twin on corpus words ({name})",
        )
        # plain, kernel, kernel, plain; the pair table is meant to stay in
        # L2, so launches are not separated by a cache flush
        p1 = time_ms(lambda: FM.fused_merge_plain(tab, r, n), 3)
        k1 = time_ms(lambda: FM.fused_merge(tab, r, n), 50)
        k2 = time_ms(lambda: FM.fused_merge(tab, r, n), 50)
        p2 = time_ms(lambda: FM.fused_merge_plain(tab, r, n), 3)
        result["ms"][name] = (k1 + k2) / 2
        result["plain_ms"][name] = (p1 + p2) / 2
        print(f"[{label}] fused merge {name:10s} {BLOCK_WORDS}x32 corpus words: "
              f"kernel {k1:.4f} / {k2:.4f} ms, plain twin {p1:.3f} / {p2:.3f} ms")
    return result


def main_path(device: str, zipf: list[str], unique: list[str], label: str) -> int:
    """Phase 4 through the facade; returns the kernel launches it made."""
    import torch

    import hutoken_tpu_torch as hutoken
    from hutoken_tpu import oracle
    from hutoken_tpu.native import NativeEngine
    from hutoken_tpu_torch.ops import fused_merge as FM

    runs = [("big-merges", "zipf", zipf), ("big-merges", "unique", unique), ("big-vocab", "zipf", zipf)]
    launches = 0
    for config, cname, docs in runs:
        vocab, special, merges = fixture_paths(config)
        kw = {"merges_file_path": merges} if merges else {}
        hutoken.initialize(vocab, special, is_byte_encoder=True, device=device, **kw)
        engine = hutoken._get_engine()
        nbytes = sum(len(d.encode()) for d in docs)

        FM.fused_merge.launches = 0
        got = hutoken.batch_encode(docs)
        cold_launches = FM.fused_merge.launches
        launches += cold_launches
        path = "pipelined" if engine._native_split_ok else "python (no native library)"
        want = NativeEngine(hutoken._ctx).encode_batch(docs, 8)
        bad = sum(g != w for g, w in zip(got, want))
        check(len(got) == len(docs) and bad == 0, f"{config}/{cname}: {bad} documents differ from native")
        rng = np.random.default_rng(1)
        sample = [int(i) for i in rng.choice(len(docs), ORACLE_SAMPLE, replace=False)]
        check(all(got[i] == oracle.encode(hutoken._ctx, docs[i]) for i in sample), f"{config}/{cname}: oracle")
        check(hutoken.batch_decode([got[i] for i in sample]) == [docs[i] for i in sample], "decode round trip")
        check(cold_launches > 0, f"{config}/{cname}: fused kernel never launched")

        engine.reset_cache()
        dev0 = engine.stat_device_bytes
        FM.fused_merge.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        hutoken.batch_encode(docs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches += FM.fused_merge.launches
        share = (engine.stat_device_bytes - dev0) / nbytes
        print(f"[{label}] main path {config:10s} {cname:6s} {nbytes / 1e6:.1f} MB, "
              f"{len(docs)} docs: equal to native (all docs) and oracle ({ORACLE_SAMPLE}); "
              f"{path} core; cold run {nbytes / 1e6 / dt:.2f} MB/s ({dt:.3f} s); "
              f"device byte share {share:.4f}; fused launches {cold_launches} + {FM.fused_merge.launches}")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    device = "cuda"

    # 1. device
    label = card_label()
    print(label)
    from hutoken_tpu.native import load_native

    native = load_native() is not None
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, native host library loaded: {native}")
    check(native, "native host library (make -C native)")

    # 2. build
    from hutoken_tpu_torch.ops import fused_merge as FM

    t0 = time.perf_counter()
    so = FM.build_library()
    print(f"built {os.path.relpath(so, HERE)} in {time.perf_counter() - t0:.1f} s")

    import bench

    t0 = time.perf_counter()
    zipf = bench.build_corpus(ZIPF_MB)
    unique = bench.build_unique_corpus(UNIQUE_MB)
    print(f"corpora built in {time.perf_counter() - t0:.1f} s")

    # 3. kernel vs plain
    kv = kernel_vs_plain(device, unique, label)

    # 4. main path; counts are zeroed inside, right before each run
    launches = main_path(device, zipf, unique, label)
    check(launches > 0, "the main path launched the fused kernel")
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules), "jax stayed unloaded")
    print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")

    print(json.dumps({"kernels": [{
        "name": "fused_merge",
        "route": "cuda",
        "source": "hutoken_tpu_torch/csrc/fused_merge.cu",
        "replaces": "hutoken_tpu/ops/pallas_merge.py:252",
        "launches": launches,
        "max_abs_err": kv["max_abs_err"],
        "ms": kv["ms"]["big-merges"],
        "plain_ms": kv["plain_ms"]["big-merges"],
        "ms_by_table": kv["ms"],
        "plain_ms_by_table": kv["plain_ms"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
