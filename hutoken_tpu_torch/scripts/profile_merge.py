"""Where the merge's time goes on the card (counterpart of
``scripts/profile_merge.py``): the fused kernel on one block, and the id
merge kernel against its eager twin on the blocks the engine sends it.

    python -m hutoken_tpu_torch.scripts.profile_merge [--tables narrow,wide,char]
    python -m hutoken_tpu_torch.scripts.profile_merge --device cpu --words 512 --eager-words 64 --tables narrow,char --char-words 256
    git archive <commit> hutoken_tpu_torch | tar -x -C build/other
    python -m hutoken_tpu_torch.scripts.profile_merge --other build/other [--rounds 2]

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
2. **long words**: ``--eager-blocks`` blocks of ``--eager-words``
   (1,024) x 128 bytes, the engine's block of words of 33-128 bytes,
   through the id merge kernel (``ops/id_merge.py::id_merge_bytes``) and
   through its eager twin (``ops/merge.py::merge_words_from_bytes_packed``:
   ``seed_from_bytes``, ``merge_fixed_point``, one ``.any()`` host sync a
   round, and ``compact_output``, whose boolean indexing syncs again).
   The words are compounds glued from the alphabetic words of the Zipf
   corpus in their order, with the leading space the split keeps, 33-128
   bytes long: neither benchmark corpus holds a word over 32 bytes.

For ``char`` (the generated 32,000-id char-mode vocabulary,
``corpora.write_char_fixture``): one block of ``--char-words`` (16,384)
x 32 ids, the char-mode seeds of distinct words of the Zipf and the
unique corpus, length-sorted, through ``ops/id_merge.py::id_merge`` and
its eager twin ``merge_words_packed``.

Per block, the kernel equal to the twin on the prefix the host reads and
a sample of rows held to the oracle; the twin's ms on the host clock
(the loop waits on the device every round anyway), its rounds (a word's
merges, the most of any row, plus the round that finds none), its
device operations a round under ``torch.profiler`` (kernels, copies,
fills) and its host syncs under ``torch.cuda.set_sync_debug_mode("warn")``;
the kernel's ms by CUDA events behind a sleep kernel, its launches and
its host syncs.

On the CPU (``--device cpu``) the twins run and every time, launch and
sync count is "not measured".

``--other DIR`` runs an A/B of the id merge kernel instead: the
checkout rooted at ``DIR`` has its ``hutoken_tpu_torch/ops`` imported
under another name, so its ``id_merge.py`` builds its kernel into its
own ``_build/``.  On three blocks (``--char-words`` x 32 char-mode ids,
and ``--eager-words`` x 128 compound bytes on the narrow and on the wide
table) both kernels are held equal to the twin on the prefix the host
reads, then timed in the order other, this, this, other, back to back
and under a cold L2 (``profile_gather.cuda_time``), ``--rounds`` times;
each line gives both means, other / this, each side's repeat ratio (the
timer's own spread) and ms a round of the twin's rounds.  First it
prints what ``ptxas -v`` reports (registers, spills) for every
instantiation of both sources.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import os
import re
import subprocess
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


def spellings(rules: dict, width: int) -> list[list[int]]:
    """For each id that ``rules`` ({(left, right): (rank, merged)}) merge
    into, the ids its merge tree spells (each merged id split by its
    lowest-ranked rule, down to ids no rule makes), when 2..``width``
    long; longest first."""
    split: dict[int, tuple[int, int, int]] = {}
    for (a, b), (r, m) in rules.items():
        if m not in split or r < split[m][0]:
            split[m] = (r, a, b)
    memo: dict[int, list[int]] = {}

    def spell(x: int, depth: int = 0) -> list[int]:
        if x not in memo:
            if x not in split or depth > width:
                memo[x] = [x]
            else:
                _r, a, b = split[x]
                memo[x] = (spell(a, depth + 1) + spell(b, depth + 1))[: width + 1]
        return memo[x]

    out = [s for s in (spell(m) for m in sorted(split)) if 2 <= len(s) <= width]
    return sorted(out, key=len, reverse=True)


EDGE_WIDTHS = (31, 32, 33, 63, 64, 65, 127, 128)
EDGE_ROWS = 16


def edge_block(rules: dict, width: int, seed: int = 0) -> np.ndarray:
    """int32 ``[EDGE_ROWS, width]`` rows (PAD = -1) at the id merge's
    edges, from ``rules`` ({(left, right): (rank, merged)}), numpy seed
    ``seed``:

    * row 0: the lowest-ranked rule (a, b) at position 0, then random
      ids of the rules: the first merge at p = 0;
    * row 1: (a, b) at the row's last pair, random ids before it that no
      rule of that rank holds: the first merge there;
    * row 2: PAD at both ends and in the middle, random ids between;
    * row 3: one id repeated over the row, the lowest-ranked rule that
      pairs an id with itself ((a, b) repeated when none does): equal
      ranks everywhere, the leftmost wins;
    * row 4: a, b, a, b, ... over the row;
    * rows 5-8: the ids that the rules' merge tree spells for merged ids
      (``spellings``), the longest four that fit: rows that merge to one
      id when the greedy order rebuilds the tree;
    * row 9 all PAD, row 10 one id, rows 11-15 random ids with one PAD
      at a random place.
    """
    rng = np.random.default_rng(seed)
    ranked = sorted(rules.items(), key=lambda kv: kv[1][0])
    (a, b), (low, _m) = ranked[0]
    ids = np.array(sorted({x for pair in rules for x in pair}), dtype=np.int32)
    held = {x for (p, q), (r, _m) in rules.items() if r == low for x in (p, q)}
    others = np.array([x for x in ids if x not in held], dtype=np.int32)
    block = ids[rng.integers(0, len(ids), (EDGE_ROWS, width))].astype(np.int32)
    block[0, :2] = a, b
    block[1] = others[rng.integers(0, len(others), width)]
    block[1, -2:] = a, b
    block[2, [0, width // 2, width - 1]] = -1
    selfs = [p for (p, q), _v in ranked if p == q]
    block[3] = selfs[0] if selfs else np.resize(np.array([a, b], dtype=np.int32), width)
    block[4] = np.resize(np.array([a, b], dtype=np.int32), width)
    block[5:9] = -1
    for row, s in zip(range(5, 9), spellings(rules, width)):
        block[row, : len(s)] = s
    block[9] = -1
    block[10] = -1
    block[10, 0] = a
    for row in range(11, EDGE_ROWS):
        block[row, rng.integers(0, width)] = -1
    return block


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


def twin_and_kernel(ctx, words, twin, kernel, W: int, seeds: int, device: str,
                    label: str, what: str, shape: str) -> None:
    """Hold ``kernel()`` to ``twin()`` (both packed) on the prefix the host
    reads and a sample of rows to the oracle, then time both and print
    one line each: ``eager fixed point ...`` and ``id kernel ...``.
    ``seeds`` is the block's seed count (its ids before merging)."""
    from ..ops.id_merge import id_merge
    from ..ops.merge import merge_fixed_point

    want = twin()
    counts, rows = unpack(want, W)
    n = W + int(counts.sum())
    launches = id_merge.launches + id_merge.wide_launches
    got = kernel()
    launched = id_merge.launches + id_merge.wide_launches - launches
    if not torch.equal(got[:n].cpu(), want[:n].cpu()):
        raise RuntimeError(f"{what}: the id kernel differs from its eager twin")
    check_rows(ctx, words, unpack(got, W)[1], what)
    row_seeds = np.asarray(seeds)
    rounds = int((row_seeds - counts).max()) + 1
    if device == "cuda":
        from torch.profiler import ProfilerActivity, profile

        from .common import top_device_ops

        twin()
        sync(device)
        t0 = time.perf_counter()
        twin()
        sync(device)
        ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            twin()
            sync(device)
        busy, top = top_device_ops(prof, n=1000)
        ops = sum(c for _n, _s, c in top)
        syncs = count_syncs(twin)
        twin_timing = (f"{ms:.3f} ms a block (device {busy * 1e3:.3f} ms), {ops / rounds:.1f} device ops "
                       f"a round ({ops} in all), {syncs} host syncs")
        calls = merge_fixed_point.calls
        kernel_timing = (f"kernel {kernel_ms(kernel):.4f} ms a block, {launched} launch, "
                         f"{count_syncs(kernel)} host syncs, eager calls {merge_fixed_point.calls - calls}")
    else:
        twin_timing = "time, device ops and host syncs not measured"
        kernel_timing = "time, launches and host syncs not measured"
    sample = min(SAMPLE, W)
    print(f"[{label}] eager fixed point {what}: {shape}, {rounds} rounds; equal to the oracle on "
          f"{sample} rows; {twin_timing}", flush=True)
    print(f"[{label}] id kernel {what}: {shape}, equal to the eager twin and the oracle on {sample} rows; "
          f"{kernel_timing}", flush=True)


def eager_rows(ctx, tab, u16: bool, docs, n_words: int, n_blocks: int, device: str,
               label: str, name: str) -> None:
    from ..ops.id_merge import id_merge_bytes
    from ..ops.merge import merge_words_from_bytes_packed, seed_from_bytes

    pool = compound_words(docs, n_words * n_blocks)
    for b in range(n_blocks):
        words, raw, lens = block_of(pool[b * n_words: (b + 1) * n_words], 128)
        raw_d, lens_d = torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device)
        seeds = (seed_from_bytes(tab.byte_seed, raw_d, lens_d) >= 0).sum(dim=1).cpu().numpy()
        twin_and_kernel(
            ctx, words, lambda: merge_words_from_bytes_packed(tab, raw_d, lens_d, u16),
            lambda: id_merge_bytes(tab, raw_d, lens_d, u16), len(words), seeds, device, label,
            f"{name} block {b}",
            f"{len(words)} x 128, words of {int(lens.min())}-{int(lens.max())} B ({int(lens.sum())} B)")


def char_rows(docs, n_words: int, device: str, label: str, directory: str) -> None:
    """One block of ``n_words`` x 32 char-mode ids (the seeds of distinct
    corpus words of 2-32 ids, length-sorted) through the id kernel and
    its eager twin."""
    from ..context import TokenizerContext
    from ..corpora import build_unique_corpus, write_char_fixture
    from ..engine import TorchTokenizer
    from ..ops.id_merge import id_merge
    from ..ops.merge import merge_words_packed

    v, s = write_char_fixture(directory)
    ctx = TokenizerContext.load(v, s, is_byte_encoder=False)
    eng = TorchTokenizer(ctx, device=device)
    tab = eng.dev_tables
    print(f"[{label}] char table: {len(ctx.vocab.id2str)} ids, wide={tab.wide}", flush=True)
    words, seeds = char_block_words(eng, docs + build_unique_corpus(0.5), n_words)
    block = np.full((len(words), 32), -1, dtype=np.int32)
    for i, sd in enumerate(seeds):
        block[i, : len(sd)] = sd
    ids = torch.from_numpy(block).to(device)
    twin_and_kernel(
        ctx, words, lambda: merge_words_packed(tab, ids, False), lambda: id_merge(tab, ids, False),
        len(words), [len(sd) for sd in seeds], device, label, "char block 0",
        f"{len(words)} x 32 ids, words of {len(seeds[0])}-{len(seeds[-1])} ids")


def char_block_words(eng, docs, n: int):
    """Up to ``n`` distinct words of ``docs`` (with the leading space the
    split keeps) whose char-mode seeds number 2-32, and their seeds, in
    corpus order, then sorted by seed count as the engine packs them."""
    found: dict[bytes, np.ndarray] = {}
    for d in docs:
        for w in d.split(" "):
            b = (" " + w).encode()
            if b in found:
                continue
            sd = eng._seed_word(b, False)
            if sd is not None and 2 <= len(sd) <= 32:
                found[b] = sd
                if len(found) == n:
                    break
        if len(found) == n:
            break
    pairs = sorted(found.items(), key=lambda kv: len(kv[1]))
    return [w for w, _s in pairs], [s for _w, s in pairs]


def load_id_merge(tree: str, name: str = "other_ops"):
    """``hutoken_tpu_torch/ops/id_merge.py`` of the checkout rooted at
    ``tree``, imported as ``<name>.id_merge``."""
    path = os.path.join(os.path.abspath(tree), "hutoken_tpu_torch", "ops")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(path, "__init__.py"), submodule_search_locations=[path])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[name] = pkg
    spec.loader.exec_module(pkg)
    return importlib.import_module(f"{name}.id_merge")


def ptxas_report(source: str) -> list[str]:
    """What ``ptxas -v`` says of each kernel instantiation of a ``.cu``
    file (compiled with the build's flags into a throwaway cubin): one
    line a kernel, its template arguments, registers, stack frame and
    spills."""
    from ..ops.build import NVCC_FLAGS, nvcc

    flags = [f for f in NVCC_FLAGS if f not in ("-shared", "-Xcompiler", "-fPIC")]
    with tempfile.TemporaryDirectory(prefix="hutoken-ptxas-") as tmp:
        proc = subprocess.run([nvcc(), *flags, "-cubin", "-Xptxas", "-v", "-o",
                               os.path.join(tmp, "k.cubin"), source],
                              capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc -Xptxas -v failed on {source}:\n{proc.stderr[-3000:]}")
    report: dict[str, list[str]] = {}
    kernel = None
    for line in proc.stderr.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w]+)'?", line)
        if m:
            kernel = m.group(1)
            continue
        if kernel and ("registers" in line or "spill" in line):
            report.setdefault(kernel, []).append(line.split(":", 1)[-1].strip().rstrip("."))
    lines = []
    for kernel, facts in report.items():
        t = re.search(r"ILi(\d+)ELi(\d+)EN2ht\d+(\w+?Table)E([is])E", kernel)
        name = f"G={t[1]} K={t[2]} {t[3]} {'int16' if t[4] == 's' else 'int32'} out" if t else kernel
        lines.append(f"{name}: " + "; ".join(dict.fromkeys(facts)))
    return lines


def ab_blocks(docs, args, directory: str, label: str) -> list:
    """The A/B's three blocks: (key, table, call arguments, 16-bit out,
    seeds a row): char-mode ids, compound bytes on the narrow (big-merges)
    and the wide (wide-merges) table."""
    from ..context import TokenizerContext
    from ..corpora import build_unique_corpus, write_char_fixture, write_wide_fixture
    from ..engine import TorchTokenizer

    v, s = write_char_fixture(os.path.join(directory, "char"))
    eng = TorchTokenizer(TokenizerContext.load(v, s, is_byte_encoder=False), device=args.device)
    _words, seeds = char_block_words(eng, docs + build_unique_corpus(0.5), args.char_words)
    ids = np.full((len(seeds), 32), -1, dtype=np.int32)
    for i, sd in enumerate(seeds):
        ids[i, : len(sd)] = sd
    blocks = [(f"char {len(seeds)}x32", eng.dev_tables, (torch.from_numpy(ids).to(args.device),),
               False, np.array([len(sd) for sd in seeds]))]
    _w, raw, lens = block_of(compound_words(docs, args.eager_words), 128)
    v, s, m = write_wide_fixture(os.path.join(directory, "wide"))
    for name, ctx in (("big-merges", load_ctx("big-merges")),
                      ("wide-merges", TokenizerContext.load(v, s, is_byte_encoder=True, merges_file_path=m))):
        eng = TorchTokenizer(ctx, device=args.device)
        blocks.append((f"{name} {len(lens)}x128", eng.dev_tables,
                       (torch.from_numpy(raw).to(args.device), torch.from_numpy(lens).to(args.device)),
                       eng._u16_out, lens))
    return blocks


def ab_other(docs, args, label: str, directory: str) -> list[dict]:
    """``--other``: the id kernel of another checkout against this one's,
    in turns (other, this, this, other) on the three blocks of
    :func:`ab_blocks`; returns a row a block."""
    from ..ops import id_merge as IM
    from ..ops.merge import merge_words_from_bytes_packed, merge_words_packed
    from ..profile_gather import cuda_time

    other = load_id_merge(args.other)
    cuda = args.device == "cuda"
    if cuda:
        for side, mod in (("this", IM), ("other", other)):
            so = mod.build()
            for line in ptxas_report(os.path.join(os.path.dirname(os.path.dirname(so)), "csrc",
                                                  "id_merge.cu")):
                print(f"[{label}] ptxas {side}: {line}", flush=True)
    rows = []
    for key, tab, xs, u16, seeds in ab_blocks(docs, args, directory, label):
        W = xs[0].shape[0]
        if len(xs) == 1:
            want = merge_words_packed(tab, xs[0], u16)
            calls = {n: (lambda m=m: m.id_merge(tab, xs[0], u16)) for n, m in (("this", IM), ("other", other))}
        else:
            want = merge_words_from_bytes_packed(tab, *xs, u16)
            calls = {n: (lambda m=m: m.id_merge_bytes(tab, *xs, u16)) for n, m in (("this", IM), ("other", other))}
        counts = want[:W].to(torch.int64) & 0xFFFF
        read = W + int(counts.sum())
        for side, call in calls.items():
            if not torch.equal(call()[:read].cpu(), want[:read].cpu()):
                raise RuntimeError(f"A/B {key}: the {side} kernel differs from the twin")
        rounds = int((np.asarray(seeds) - counts.cpu().numpy()).max()) + 1
        what = f"[{label}] A/B id kernel {key} ({'wide' if tab.wide else 'narrow'}, {rounds} rounds)"
        if not cuda:
            print(f"{what}: both equal to the twin; times not measured", flush=True)
            continue
        got: dict = {}
        for _ in range(args.rounds):
            for cold in (False, True):
                for side in ("other", "this", "this", "other"):
                    got.setdefault((side, cold), []).append(cuda_time(calls[side], cold=cold))
        row = {"block": key, "rounds": rounds}
        parts = []
        for cold, tag in ((False, "ms"), (True, "cold_ms")):
            t_o, t_t = got[("other", cold)], got[("this", cold)]
            row[f"other_{tag}"], row[f"this_{tag}"] = sum(t_o) / len(t_o), sum(t_t) / len(t_t)
            row[f"ratio_{tag}"] = row[f"other_{tag}"] / row[f"this_{tag}"]
            parts.append(f"{'cold: ' if cold else ''}other {row[f'other_{tag}']:.4f} ms, this "
                         f"{row[f'this_{tag}']:.4f} ms, other / this {row[f'ratio_{tag}']:.3f} "
                         f"(repeats {max(t_o) / min(t_o):.3f}, {max(t_t) / min(t_t):.3f}); ms a round "
                         f"other {row[f'other_{tag}'] / rounds:.5f}, this {row[f'this_{tag}'] / rounds:.5f}")
        rows.append(row)
        print(f"{what}, equal to the twin: " + "; ".join(parts), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tables", default="narrow,wide,char", help="narrow, wide, char, or a list")
    ap.add_argument("--words", type=int, default=16384, help="words of the fused block")
    ap.add_argument("--eager-words", type=int, default=1024, help="words of an eager block")
    ap.add_argument("--eager-blocks", type=int, default=2)
    ap.add_argument("--char-words", type=int, default=16384, help="words of the char-mode block")
    ap.add_argument("--mb", type=float, default=4.0, help="Zipf corpus MB the words come from")
    ap.add_argument("--other", help="A/B the id kernel against this checkout's (see above)")
    ap.add_argument("--rounds", type=int, default=2, help="A/B rounds of other, this, this, other")
    add_device_arg(ap)
    args = ap.parse_args(argv)
    label = open_device(args.device)

    from ..context import TokenizerContext
    from ..corpora import write_wide_fixture
    from ..engine import TorchTokenizer

    docs = build_corpus(args.mb)
    with tempfile.TemporaryDirectory(prefix="hutoken-wide-") as tmp:
        if args.other:
            ab_other(docs, args, label, tmp)
            return 0
        for name in args.tables.split(","):
            if name == "char":
                char_rows(docs, args.char_words, args.device, label, os.path.join(tmp, "char"))
                continue
            if name == "narrow":
                ctx = load_ctx("big-merges")
            elif name == "wide":
                v, s, m = write_wide_fixture(os.path.join(tmp, "wide"))
                ctx = TokenizerContext.load(v, s, is_byte_encoder=True, merges_file_path=m)
            else:
                raise ValueError(f"unknown table {name!r}: narrow, wide or char")
            eng = TorchTokenizer(ctx, device=args.device)
            tab, u16 = eng.dev_tables, eng._u16_out
            print(f"[{label}] {name} table: {len(ctx.vocab.id2str)} ids, wide={tab.wide}, "
                  f"16-bit output={u16}", flush=True)
            fused_rows(ctx, tab, u16, docs, args.words, args.device, label, name)
            eager_rows(ctx, tab, u16, docs, args.eager_words, args.eager_blocks, args.device, label, name)
    return 0


if __name__ == "__main__":
    sys.exit(main())
