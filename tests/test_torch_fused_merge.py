"""The fused merge (hutoken_tpu_torch/ops/fused_merge.py): its plain
PyTorch twin against the Pallas kernel it replaces, run in interpret
mode, and against the scalar oracle; the CUDA kernel against the twin
on the card.  Token ids are integers: every comparison is exact."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.ops import pallas_merge as PM  # noqa: E402
from hutoken_tpu_torch.ops import fused_merge as FM  # noqa: E402

torch.set_num_threads(1)


def _pallas(name, raw, lens, gw, u16_out):
    ctx, enc = tp.load(name)
    ptab = PM.build_pallas_table(enc.pairs, enc.byte_seed_ids, ctx.vocab.id2str)
    return ptab, np.asarray(
        PM.merge_words_from_bytes_pallas(
            ptab, jnp.asarray(raw), jnp.asarray(lens), u16_out,
            group_w=gw, interpret=True,
            full_table=tp.jax_packed_table(enc) if ptab.partial else None,
        )
    )


def _fused(name, raw, lens, u16_out):
    got = FM.merge_words_from_bytes_fused(
        tp.device_tables_cpu(name), torch.from_numpy(raw), torch.from_numpy(lens), u16_out
    ).numpy()
    return got.view(np.uint16) if u16_out else got


def _assert_oracle(name, raw, lens, got):
    ctx, _enc = tp.load(name)
    for i, toks in enumerate(tp.unpack(got, raw.shape[0])):
        wb = bytes(raw[i, : lens[i]])
        assert toks == (oracle.encode_word(ctx, wb, None) if lens[i] else []), wb


@pytest.mark.parametrize("gw", [8, 16, 32])
def test_twin_matches_pallas_small(gw):
    rng = np.random.default_rng(11 + gw)
    raw, lens = tp.word_block(rng, PM.ROW_TILE * (128 // gw), gw)
    _ptab, want = _pallas("small", raw, lens, gw, True)
    got = _fused("small", raw, lens, True)
    assert np.array_equal(got, want)
    _assert_oracle("small", raw, lens, got)


def test_twin_matches_pallas_high_bytes():
    """Bytes >= 0x80 read the upper half of the 256-entry LUT."""
    rng = np.random.default_rng(5)
    raw, lens = tp.word_block(rng, PM.ROW_TILE * 8, 16, charset=tp.HIGH_BYTES)
    _ptab, want = _pallas("small", raw, lens, 16, False)
    got = _fused("small", raw, lens, False)
    assert np.array_equal(got, want)
    _assert_oracle("small", raw, lens, got)


@pytest.mark.parametrize("gw", [8, 32])
def test_twin_matches_pallas_big_merges(gw):
    """GPT-2-style merges.txt: ranks differ from merged ids, so the
    minsuper bound comes from its own plane in the Pallas table."""
    rng = np.random.default_rng(21 + gw)
    raw, lens = tp.word_block(rng, PM.ROW_TILE * (128 // gw), gw)
    ptab, want = _pallas("big-merges", raw, lens, gw, True)
    assert not ptab.partial and not ptab.rank_in_val
    got = _fused("big-merges", raw, lens, True)
    assert np.array_equal(got, want)
    _assert_oracle("big-merges", raw, lens, got)


def test_twin_exact_where_pallas_table_is_partial():
    """The big string-path vocab overflows the Pallas bucket budget: its
    partial table flags diverged words (count bit 0x8000).  The twin
    probes the full table, so it equals Pallas on unflagged words and
    the oracle on every word."""
    rng = np.random.default_rng(8)
    raw, lens = tp.word_block(rng, PM.ROW_TILE * 8, 16)
    ptab, want = _pallas("big-vocab", raw, lens, 16, True)
    assert ptab.partial
    got = _fused("big-vocab", raw, lens, True)
    W = raw.shape[0]
    assert not (got[:W] & 0x8000).any()
    flagged = (want[:W] & 0x8000) != 0
    want_rows, got_rows = tp.unpack(want, W), tp.unpack(got, W)
    for i in np.flatnonzero(~flagged):
        assert got_rows[i] == want_rows[i]
    _assert_oracle("big-vocab", raw, lens, got)


@pytest.mark.parametrize("name", tp.BYTE_CONFIGS)
def test_twin_single_merge_rounds(name):
    """Without a minsuper bound the twin applies one merge per word per
    round, and reaches the same fixed point."""
    tab = tp.device_tables_cpu(name)
    assert tab.minsuper is not None
    rng = np.random.default_rng(2)
    raw, lens = tp.word_block(rng, 512, 32)
    multi = FM.fused_merge(tab, torch.from_numpy(raw), torch.from_numpy(lens))
    single = FM.fused_merge(
        dataclasses.replace(tab, minsuper=None), torch.from_numpy(raw), torch.from_numpy(lens)
    )
    assert all(torch.equal(x, y) for x, y in zip(multi, single))


def test_fused_merge_checks_inputs():
    tab = tp.device_tables_cpu("small")
    ok = torch.zeros((4, 8), dtype=torch.uint8)
    lens = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="at most 32 bytes"):
        FM.fused_merge(tab, torch.zeros((4, 33), dtype=torch.uint8), lens)
    with pytest.raises(ValueError, match="uint8"):
        FM.fused_merge(tab, ok.to(torch.int32), lens)
    with pytest.raises(ValueError, match="lens"):
        FM.fused_merge(tab, ok, lens.to(torch.int64))
    launches = FM.fused_merge.launches
    ids, counts = FM.fused_merge(tab, ok, lens)  # CPU tensors: the twin
    assert FM.fused_merge.launches == launches
    assert ids.shape == (4, 8) and counts.tolist() == [0, 0, 0, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("name", tp.BYTE_CONFIGS)
def test_kernel_matches_twin_on_cuda(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    ctx, enc = tp.load(name)
    from hutoken_tpu_torch.tables import device_tables

    tab = device_tables(enc, ctx, "cuda")
    rng = np.random.default_rng(4)
    for width in (8, 16, 32):
        raw, lens = tp.word_block(rng, 12345, width, charset=tp.HIGH_BYTES)
        r, n = torch.from_numpy(raw).cuda(), torch.from_numpy(lens).cuda()
        got = FM.fused_merge(tab, r, n)
        want = FM.fused_merge_plain(tab, r, n)
        torch.cuda.synchronize()
        assert all(torch.equal(x, y) for x, y in zip(got, want))
