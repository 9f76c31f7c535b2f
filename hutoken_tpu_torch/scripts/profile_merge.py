"""Where the merge's time goes on the card (counterpart of
``scripts/profile_merge.py``): the fused kernel on one block, and the
eager fixed point that serves words of 33-128 bytes.

    python -m hutoken_tpu_torch.scripts.profile_merge [--tables narrow,wide]
    python -m hutoken_tpu_torch.scripts.profile_merge --device cpu --words 512 --eager-words 64 --tables narrow

For each table, ``narrow`` (the committed 23,096-id fixture with its
merges.txt, the 16-bit packed table) and ``wide`` (the generated
100,256-id vocabulary with its merges.txt, ``corpora.write_wide_fixture``,
the wide table):

1. **fused merge**: one block of ``--words`` (16,384) distinct words of
   the Zipf corpus of 2 to ``width`` bytes, length-sorted as the engine
   packs them, through ``ops/fused_merge.py::merge_words_from_bytes_fused``
   at widths 8, 16 and 32: the kernel equal to ``compact_output`` of its
   plain twin on the prefix the host reads, its time by CUDA events
   behind a sleep kernel (``profile_gather.cuda_time``);
2. **eager fixed point**: ``--eager-blocks`` blocks of ``--eager-words``
   (1,024) x 128 bytes through ``ops/merge.py::merge_words_from_bytes_packed``,
   the engine's call for words of 33-128 bytes: ``seed_from_bytes``,
   ``merge_fixed_point`` (one ``.any()`` host sync a round) and
   ``compact_output`` (whose boolean indexing syncs again).  The words
   are compounds glued from the alphabetic words of the Zipf corpus in
   their order, with the leading space the split keeps, 33-128 bytes long:
   neither benchmark corpus holds a word over 32 bytes.  Per block: ms
   on the host clock (the loop waits on the device every round anyway),
   the rounds (a word's merges, the most of any row, plus the round that
   finds none), the device operations a round under ``torch.profiler``
   (kernels, copies, fills), and the host syncs counted under
   ``torch.cuda.set_sync_debug_mode("warn")``; a sample of rows is held
   to the oracle.

On the CPU (``--device cpu``) the twins run and every time, launch and
sync count is "not measured".
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
import warnings

import numpy as np
import torch

from ..corpora import build_corpus
from .common import add_device_arg, kernel_ms, load_ctx, open_device, sync

WIDTHS = (8, 16, 32)
SAMPLE = 32  # rows of each output held to the oracle


def distinct_words(docs, lo: int, hi: int, n: int) -> list[bytes]:
    """Up to ``n`` distinct words of ``lo..hi`` bytes, with the leading
    space the split keeps, in corpus order."""
    seen: dict[bytes, None] = {}
    for d in docs:
        for w in d.split(" "):
            b = (" " + w).encode()
            if lo <= len(b) <= hi:
                seen.setdefault(b, None)
                if len(seen) == n:
                    return list(seen)
    return list(seen)


def compound_words(docs, n: int, lo: int = 33, hi: int = 128) -> list[bytes]:
    """``n`` distinct compounds glued from the corpus's alphabetic words in
    their order (a leading space, then the words; other words are
    skipped), each grown to a length drawn from ``lo..hi`` bytes (numpy,
    seed 0)."""
    rng = np.random.default_rng(0)
    out: dict[bytes, None] = {}
    cur, target = b"", int(rng.integers(lo, hi + 1))
    for d in docs:
        for w in d.split(" "):
            if not w.isalpha():
                continue
            cur += w.encode()
            if len(cur) + 1 > hi:
                cur = w.encode()
            if len(cur) + 1 >= target:
                out.setdefault(b" " + cur, None)
                cur, target = b"", int(rng.integers(lo, hi + 1))
                if len(out) == n:
                    return list(out)
    raise ValueError(f"the corpus gives only {len(out)} compounds of {lo}-{hi} bytes")


def block_of(words: list[bytes], width: int):
    words = sorted(words, key=len)
    raw = np.zeros((len(words), width), dtype=np.uint8)
    lens = np.array([len(w) for w in words], dtype=np.int32)
    for i, w in enumerate(words):
        raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    return words, raw, lens


def unpack(packed: torch.Tensor, W: int):
    """(counts, per-row token lists) of a packed output."""
    out = packed.cpu().numpy()
    if out.dtype == np.int16:
        out = out.view(np.uint16)
    counts = out[:W].astype(np.int64) & 0x7FFF
    starts = W + np.concatenate(([0], np.cumsum(counts)[:-1]))
    return counts, [out[s: s + c].tolist() for s, c in zip(starts, counts)]


def check_rows(ctx, words, rows, what: str) -> None:
    from .. import oracle

    for i in sorted({int(x) for x in np.linspace(0, len(words) - 1, min(SAMPLE, len(words)))}):
        if rows[i] != oracle.encode_word(ctx, words[i], None):
            raise RuntimeError(f"{what}: row {i} differs from the oracle")


def fused_rows(ctx, tab, u16: bool, docs, n_words: int, device: str, label: str, name: str) -> None:
    from ..ops.fused_merge import fused_merge_plain, merge_words_from_bytes_fused
    from ..ops.merge import compact_output

    for width in WIDTHS:
        words, raw, lens = block_of(distinct_words(docs, 2, width, n_words), width)
        raw_d, lens_d = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
        out = merge_words_from_bytes_fused(tab, raw_d, lens_d, u16)
        want = compact_output(fused_merge_plain(tab, raw_d, lens_d)[0], u16)
        W = len(words)
        n = W + int(unpack(want, W)[0].sum())
        if not torch.equal(out[:n].cpu(), want[:n].cpu()):
            raise RuntimeError(f"{name} width {width}: the fused kernel differs from its twin")
        check_rows(ctx, words, unpack(out, W)[1], f"{name} fused width {width}")
        ms = (f"{kernel_ms(lambda: merge_words_from_bytes_fused(tab, raw_d, lens_d, u16)):.4f} ms"
              if device == "cuda" else "not measured")
        print(f"[{label}] fused merge {name} {W} x {width}: {int(lens.sum())} B, equal to the twin "
              f"and the oracle; kernel {ms}", flush=True)


def count_syncs(fn) -> int:
    """Host syncs of ``fn()`` under sync debug mode "warn"."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return sum("synchroniz" in str(w.message) for w in caught)


def eager_rows(ctx, tab, u16: bool, docs, n_words: int, n_blocks: int, device: str,
               label: str, name: str) -> None:
    from ..ops.merge import merge_words_from_bytes_packed, seed_from_bytes

    pool = compound_words(docs, n_words * n_blocks)
    for b in range(n_blocks):
        words, raw, lens = block_of(pool[b * n_words: (b + 1) * n_words], 128)
        raw_d, lens_d = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)

        def call():
            return merge_words_from_bytes_packed(tab, raw_d, lens_d, u16)

        counts, rows = unpack(call(), len(words))
        check_rows(ctx, words, rows, f"{name} eager block {b}")
        seeds = (seed_from_bytes(tab.byte_seed, raw_d, lens_d) >= 0).sum(dim=1).cpu().numpy()
        rounds = int((seeds - counts).max()) + 1
        if device == "cuda":
            from torch.profiler import ProfilerActivity, profile

            from .common import top_device_ops

            call()
            sync(device)
            t0 = time.perf_counter()
            call()
            sync(device)
            ms = (time.perf_counter() - t0) * 1e3
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                call()
                sync(device)
            busy, top = top_device_ops(prof, n=1000)
            ops = sum(c for _n, _s, c in top)
            syncs = count_syncs(call)
            timing = (f"{ms:.3f} ms a block (device {busy * 1e3:.3f} ms), {ops / rounds:.1f} device ops "
                      f"a round ({ops} in all), {syncs} host syncs")
        else:
            timing = "time, device ops and host syncs not measured"
        print(f"[{label}] eager fixed point {name} block {b}: {len(words)} x 128, words of "
              f"{int(lens.min())}-{int(lens.max())} B ({int(lens.sum())} B), {rounds} rounds; "
              f"equal to the oracle on {min(SAMPLE, len(words))} rows; {timing}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default="narrow,wide", help="narrow, wide or both")
    ap.add_argument("--words", type=int, default=16384, help="words of the fused block")
    ap.add_argument("--eager-words", type=int, default=1024, help="words of an eager block")
    ap.add_argument("--eager-blocks", type=int, default=2)
    ap.add_argument("--mb", type=float, default=4.0, help="Zipf corpus MB the words come from")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    label = open_device(args.device)

    from ..context import TokenizerContext
    from ..corpora import write_wide_fixture
    from ..engine import TorchTokenizer

    docs = build_corpus(args.mb)
    with tempfile.TemporaryDirectory(prefix="hutoken-wide-") as tmp:
        for name in args.tables.split(","):
            if name == "narrow":
                ctx = load_ctx("big-merges")
            elif name == "wide":
                v, s, m = write_wide_fixture(os.path.join(tmp, "wide"))
                ctx = TokenizerContext.load(v, s, is_byte_encoder=True, merges_file_path=m)
            else:
                raise ValueError(f"unknown table {name!r}: narrow or wide")
            eng = TorchTokenizer(ctx, device=args.device)
            tab, u16 = eng.dev_tables, eng._u16_out
            print(f"[{label}] {name} table: {len(ctx.vocab.id2str)} ids, wide={tab.wide}, "
                  f"16-bit output={u16}", flush=True)
            fused_rows(ctx, tab, u16, docs, args.words, args.device, label, name)
            eager_rows(ctx, tab, u16, docs, args.eager_words, args.eager_blocks, args.device, label, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
