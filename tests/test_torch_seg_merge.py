"""The segmented merge (hutoken_tpu_torch/ops/seg_merge.py): its plain
PyTorch twin against the Pallas kernel it replaces (``_kernel_seg``, run
in interpret mode) and the scalar oracle; the kernel build's digest; the
CUDA kernel against the twin on the card.  Token ids are integers: every
comparison is exact."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.ops import pallas_merge as PM  # noqa: E402
from hutoken_tpu_torch.ops import build as B  # noqa: E402
from hutoken_tpu_torch.ops import fused_merge as FM  # noqa: E402
from hutoken_tpu_torch.ops import seg_merge as SM  # noqa: E402

torch.set_num_threads(1)
DEAD = 1 << 12


def _windowed_block(rng, R: int):
    """The windowed ``raw``/``aux`` of test_split_device.py's
    test_segmented_kernel_parity: words of 1..32 letters at arbitrary
    lanes of 128-lane rows, with dead gaps.  Returns (raw, aux, words),
    words as (row, first lane, length)."""
    letters = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz ", dtype=np.uint8)
    raw = np.zeros((R, 128), dtype=np.uint8)
    aux = np.full((R, 128), DEAD, dtype=np.int32)
    words = []
    for r in range(R):
        cur = 0
        while cur < 128:
            if rng.random() < 0.25:  # dead gap
                cur += int(rng.integers(1, 5))
                continue
            ln = int(rng.integers(1, 33))
            if cur + ln > 128:
                break
            raw[r, cur : cur + ln] = letters[rng.integers(0, len(letters), ln)]
            for j in range(ln):
                aux[r, cur + j] = j | ((cur + ln - 1) << 5)
            words.append((r, cur, ln))
            cur += ln
    # dead lanes: gend = own lane so the kernel's nxt0 self-points
    lanes = np.arange(128, dtype=np.int32)[None, :]
    aux = np.where(aux == DEAD, DEAD | (lanes << 5), aux)
    return raw, aux, words


def _pallas_seg(name, raw, aux):
    ctx, enc = tp.load(name)
    ptab = PM.build_pallas_table(enc.pairs, enc.byte_seed_ids, ctx.vocab.id2str)
    out, _nxt = PM._pallas_merge_seg_call(
        jnp.asarray(ptab.tk), jnp.asarray(ptab.tv), jnp.asarray(ptab.tv2),
        jnp.asarray(ptab.lut), jnp.asarray(raw), jnp.asarray(aux),
        depth=ptab.depth, rank_in_val=ptab.rank_in_val,
        multi_ok=ptab.multi_ok, interpret=True,
    )
    return ptab, np.asarray(out)


def _port_seg(name, raw, words):
    """Row r of the block becomes bytes r*128 .. r*128+127 of a chunk."""
    starts = np.array([r * 128 + c for r, c, _ln in words], dtype=np.int32)
    lens = np.array([ln for _r, _c, ln in words], dtype=np.int32)
    ids = SM.seg_merge(
        tp.device_tables_cpu(name), torch.from_numpy(raw.reshape(-1).copy()),
        torch.from_numpy(starts), torch.from_numpy(lens),
    )
    return ids.numpy().reshape(raw.shape)


def _word_ids(block, r, c, ln):
    span = block[r, c : c + ln]
    return span[span >= 0].tolist()


@pytest.mark.parametrize("name,seed", [("small", 123), ("big-merges", 7)])
def test_twin_matches_pallas_seg(name, seed):
    """Full Pallas tables: equal at every byte, holes included."""
    raw, aux, words = _windowed_block(np.random.default_rng(seed), PM.ROW_TILE)
    ptab, want = _pallas_seg(name, raw, aux)
    assert not ptab.partial
    got = _port_seg(name, raw, words)
    assert np.array_equal(got, want)
    ctx, _enc = tp.load(name)
    for r, c, ln in words[::7]:
        assert _word_ids(got, r, c, ln) == oracle.encode_word(ctx, bytes(raw[r, c : c + ln]), None)


def test_twin_exact_where_pallas_seg_table_is_partial():
    """The big string-path vocab overflows the Pallas bucket budget.  A
    word whose final adjacent pair still has a rule diverged on the
    partial table (the raw program flags it for a host re-encode); on
    every other word the twin equals Pallas byte for byte, and on every
    word it equals the oracle."""
    raw, aux, words = _windowed_block(np.random.default_rng(3), PM.ROW_TILE)
    ptab, want = _pallas_seg("big-vocab", raw, aux)
    assert ptab.partial
    got = _port_seg("big-vocab", raw, words)
    ctx, enc = tp.load("big-vocab")
    n_unflagged = 0
    for r, c, ln in words:
        jax_ids = _word_ids(want, r, c, ln)
        flagged = any((a, b) in enc.pairs for a, b in zip(jax_ids, jax_ids[1:]))
        if not flagged:
            n_unflagged += 1
            assert np.array_equal(got[r, c : c + ln], want[r, c : c + ln])
        assert _word_ids(got, r, c, ln) == oracle.encode_word(ctx, bytes(raw[r, c : c + ln]), None)
    assert n_unflagged > len(words) // 2
    dead = np.ones(raw.shape, dtype=bool)
    for r, c, ln in words:
        dead[r, c : c + ln] = False
    assert (got[dead] == -1).all()


def test_twin_carries_offsets_like_fused_merge():
    """The twin's tokens per word equal the fused twin's on the same
    words (the ids in order; the offsets only place them)."""
    rng = np.random.default_rng(17)
    tab = tp.device_tables_cpu("big-merges")
    raw, lens = tp.word_block(rng, 300, 32, lo=1)
    chunk = torch.from_numpy(raw.reshape(-1).copy())
    starts = torch.arange(0, 300 * 32, 32, dtype=torch.int32)
    ids = SM.seg_merge(tab, chunk, starts, torch.from_numpy(lens)).reshape(300, 32)
    f_ids, f_counts = FM.fused_merge(tab, torch.from_numpy(raw), torch.from_numpy(lens))
    for w in range(300):
        row = ids[w][ids[w] >= 0]
        assert row.tolist() == f_ids[w, : f_counts[w]].tolist()


def test_seg_merge_checks_inputs():
    tab = tp.device_tables_cpu("small")
    chunk = torch.zeros(64, dtype=torch.uint8)
    starts = torch.tensor([0, 10], dtype=torch.int32)
    lens = torch.tensor([3, 5], dtype=torch.int32)
    with pytest.raises(ValueError, match="uint8"):
        SM.seg_merge(tab, chunk.to(torch.int32), starts, lens)
    with pytest.raises(ValueError, match="word_start"):
        SM.seg_merge(tab, chunk, starts.to(torch.int64), lens)
    with pytest.raises(ValueError, match="differ in length"):
        SM.seg_merge(tab, chunk, starts, lens[:1])
    launches = SM.seg_merge.launches
    out = SM.seg_merge(tab, chunk, starts, lens)  # CPU tensors: the twin
    assert SM.seg_merge.launches == launches
    assert out.shape == (64,) and out.dtype == torch.int32
    assert (out[20:] == -1).all() and (out[[0, 10]] >= 0).all()
    empty = SM.seg_merge(tab, chunk, starts[:0], lens[:0])
    assert (empty == -1).all()


def test_build_digest_covers_headers(tmp_path):
    """The digest covers every header a kernel includes with quotes,
    directly or through another header: changing a header's bytes
    changes it, so an edited header never loads a stale build."""
    (tmp_path / "k.cu").write_text('#include <cstdint>\n#include "a.cuh"\nint f() { return g(); }\n')
    (tmp_path / "a.cuh").write_text('#pragma once\n#include "b.cuh"\ninline int g() { return h(); }\n')
    (tmp_path / "b.cuh").write_text("#pragma once\ninline int h() { return 1; }\n")
    files = B.kernel_files(str(tmp_path / "k.cu"))
    assert [os.path.basename(f) for f in files] == ["k.cu", "a.cuh", "b.cuh"]
    d0 = B.source_digest(files)
    assert B.source_digest(files) == d0
    (tmp_path / "b.cuh").write_text("#pragma once\ninline int h() { return 2; }\n")
    assert B.source_digest(files) != d0
    assert B.source_digest(files, flags=("-O0",)) != B.source_digest(files)


@pytest.mark.parametrize("name", ["fused_merge", "seg_merge"])
def test_kernels_digest_their_shared_header(name):
    files = B.kernel_files(os.path.join(B.CSRC, f"{name}.cu"))
    assert [os.path.basename(f) for f in files] == [f"{name}.cu", "merge_warp.cuh"]
    assert all(os.path.exists(f) for f in files)


@pytest.mark.cuda
@pytest.mark.parametrize("name", tp.BYTE_CONFIGS)
def test_kernel_matches_twin_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from hutoken_tpu_torch.ops import split as S
    from hutoken_tpu_torch.tables import device_tables

    ctx, enc = tp.load(name)
    tab = device_tables(enc, ctx, "cuda")
    rng = np.random.default_rng(4)
    raw, lens = tp.word_block(rng, 4000, 32, charset=tp.HIGH_BYTES)
    text = b" ".join(bytes(r[:n]) for r, n in zip(raw, lens)).decode("latin-1").encode()
    chunk = torch.from_numpy(np.frombuffer(text, dtype=np.uint8).copy()).cuda()
    seg_ends = torch.tensor([chunk.shape[0] // 2, chunk.shape[0]], dtype=torch.int32).cuda()
    starts, lens = S.chunk_words(chunk, seg_ends)
    lens = torch.where(lens > 32, 0, lens)  # skipped, as the raw path does
    args = (tab, chunk, starts.to(torch.int32), lens.to(torch.int32))
    got = SM.seg_merge(*args)
    want = SM.seg_merge_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
