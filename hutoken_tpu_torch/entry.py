"""Driver entry points of the port (counterpart of ``__graft_entry__.py``).

``entry()`` returns ``(fn, example_args)`` on the flagship path, the
fused byte-level merge ``ops/fused_merge.py::merge_words_from_bytes_fused``,
over a tiny table trained by the port's ``bbpe_train_core``.

``dryrun_multichip(n)`` runs, on an ``n``-shard ``data_mesh``, one full
distributed training step (pair count, reduction over the shards, pick,
merge apply), a sharded merge block checked against the oracle, the
mesh engine's ``encode_batch`` against ``oracle.encode`` and its decode
round trip, on tiny shapes.  Several shards may share one card (or the
CPU with ``device="cpu"``): that checks the mechanics, not scaling.

    python -m hutoken_tpu_torch.entry               # on the card
    python -m hutoken_tpu_torch.entry --device cpu  # on 8 CPU shards

Left out: the JAX entry's ``jax.jit`` compile check (eager PyTorch
compiles nothing; the CUDA kernels build at their first launch) and its
pin of the platform to the CPU.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

TRAIN_TEXT = b"the cat sat on the mat and the dog sat on the log " * 8
DRYRUN_TEXT = b"abababab the cat sat on the mat " * 16
DOCS = [
    "A gyors barna róka átugrik a lusta kutya fölött.",
    " The quick brown fox jumps over the lazy dog.",
    "Öt szűk ütközőpont: 0xFF, 3.14159.",
    "tokenek és bájtok " * 20,
] * 4


def tiny_context():
    """A byte-level context over a ``bbpe_train_core`` vocabulary asked
    for 300 ids (the training stops where no pair repeats).  The trainer
    keys its tokens by raw bytes (byte 0 as the empty string, as the
    reference's C strings end there); each is stored as byte mode spells
    it under GPT-2's byte map, so that every byte seeds one id."""
    from .bytemaps import gpt2_special_chars_table
    from .context import TokenizerContext
    from .formats import Vocab
    from .pretokenize import encode_remap
    from .train.bbpe import bbpe_train_core

    special = {b: s.encode("utf-8") for b, s in gpt2_special_chars_table().items()}
    trained = bbpe_train_core(TRAIN_TEXT, 300, verbose=False)
    str2id = {encode_remap(bytes([i]) if i < 256 else tok, special, None, True): i
              for tok, i in trained.items()}
    vocab = Vocab(str2id=str2id, id2str={i: s for s, i in str2id.items()},
                  size=max(str2id.values()) + 1)
    return TokenizerContext(vocab=vocab, special_chars=special, is_byte_encoder=True)


def tiny_tables(device):
    """(context, device tables) of :func:`tiny_context` on ``device``."""
    from .tables import build_encoder_tables, device_tables

    ctx = tiny_context()
    return ctx, device_tables(build_encoder_tables(ctx), ctx, device)


def entry(device: str = "cuda"):
    """``(fn, example_args)``: ``fn(raw, lens)`` merges a ``[256, 16]``
    uint8 block of training-text slices (numpy, seed 0) on ``device``
    through ``merge_words_from_bytes_fused`` and returns its packed
    output (int16 holding uint16 ids): the counts, then the tokens; on
    the card only the prefix ``W + sum(counts)`` is defined."""
    from .ops.fused_merge import merge_words_from_bytes_fused

    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry: no CUDA device; pass device='cpu'")
    _ctx, tab = tiny_tables(device)
    rng = np.random.RandomState(0)
    text = np.frombuffer(TRAIN_TEXT, dtype=np.uint8)
    W, L = 256, 16
    starts = rng.randint(0, text.shape[0] - L, size=W)
    raw = text[starts[:, None] + np.arange(L)[None, :]].copy()
    lens = rng.randint(0, L + 1, size=W).astype(np.int32)
    raw[np.arange(L)[None, :] >= lens[:, None]] = 0

    def fn(raw_t, lens_t):
        return merge_words_from_bytes_fused(tab, raw_t, lens_t, True)

    return fn, (torch.from_numpy(raw).to(device), torch.from_numpy(lens).to(device))


def dryrun_multichip(n_devices: int, device: str = "cuda") -> None:
    """One distributed training step, a sharded merge block and the mesh
    engine on ``data_mesh(n_devices, device)``; raises on any mismatch."""
    from . import oracle
    from .context import TokenizerContext
    from .engine import TorchTokenizer
    from .parallel.mesh import data_mesh, shard_batch
    from .parallel.sharded import sharded_merge_words
    from .parallel.train import make_train_step
    from .scripts.common import fixture_paths

    mesh = data_mesh(n_devices, device)

    # --- distributed training step (count + reduction + pick + merge) ---
    train_step, merge_step, _fused = make_train_step(300, mesh)
    ids = shard_batch(mesh, np.frombuffer(DRYRUN_TEXT, dtype=np.uint8).astype(np.int32))
    id1, id2, cnt, ok = train_step(ids)
    if not bool(ok):
        raise RuntimeError("the dense pick is always exact, yet ok is false")
    if int(cnt) < 2:
        raise RuntimeError(f"expected a repeated pair, got count {int(cnt)}")
    merged = merge_step(ids, id1, id2, 256)
    if sum(int((m == 256).sum()) for m in merged) == 0:
        raise RuntimeError("the merge applied no pairs")

    # --- sharded encode: the merge fixed point with rows over the shards ---
    ctx, tab = tiny_tables(mesh.devices[0])
    rng = np.random.RandomState(0)
    W = 8 * n_devices
    block = rng.randint(0, 256, size=(W, 16)).astype(np.int32)
    out = torch.cat([o.cpu() for o in sharded_merge_words(tab, mesh, block)])
    if tuple(out.shape) != (W, 16):
        raise RuntimeError(f"sharded merge gave shape {tuple(out.shape)}, not {(W, 16)}")
    elements = [ctx.vocab.id2str[int(x)] for x in block[0]]
    want = oracle._merge_string_path(elements, ctx.vocab.str2id)
    got = [int(x) for x in out[0] if x != -1]
    if got != want:
        raise RuntimeError(f"sharded merge diverged: {got} vs {want}")

    # --- mesh-aware engine: full encode_batch over the mesh ---
    vocab, special, _merges = fixture_paths("small")
    bctx = TokenizerContext.load(vocab, special, is_byte_encoder=True)
    engine = TorchTokenizer(bctx, mesh=mesh)
    got_docs = engine.encode_batch(DOCS)
    if got_docs != [oracle.encode(bctx, d) for d in DOCS]:
        raise RuntimeError("mesh engine batch diverged from the oracle")
    if engine.decode_batch(got_docs) != DOCS:
        raise RuntimeError("mesh engine decode round trip failed")
    print(f"dryrun_multichip({n_devices}, {device!r}): OK", flush=True)


def main(argv=None) -> int:
    from .ops.merge import compact_output
    from .ops.fused_merge import fused_merge_plain
    from .scripts.common import add_device_arg, open_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_device_arg(ap)
    ap.add_argument("--shards", type=int, default=8, help="dryrun_multichip's mesh size")
    args = ap.parse_args(argv)
    open_device(args.device)
    fn, example = entry(args.device)
    out = fn(*example)
    raw, lens = example
    _ctx, tab = tiny_tables(args.device)
    want = compact_output(fused_merge_plain(tab, raw, lens)[0], True)
    n = raw.shape[0] + int(want[: raw.shape[0]].sum())
    if not torch.equal(out[:n].cpu(), want[:n].cpu()):
        raise RuntimeError("entry: the fused merge differs from its plain twin")
    print(f"entry: ran, packed output {tuple(out.shape)} {out.dtype}, "
          f"{n - raw.shape[0]} tokens equal to the plain twin", flush=True)
    dryrun_multichip(args.shards, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
