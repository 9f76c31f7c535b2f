"""The PyTorch merge ops (hutoken_tpu_torch/ops/merge.py, tables.py)
against hutoken_tpu.ops.merge and the numpy table code, on the same
seeded inputs.  Token ids are integers: every comparison is exact."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from hutoken_tpu.ops import merge as JM  # noqa: E402
from hutoken_tpu.ops import pallas_merge as PM  # noqa: E402
from hutoken_tpu.tables import _mix_hash, build_pair_table  # noqa: E402
from hutoken_tpu_torch.ops import merge as TM  # noqa: E402
from hutoken_tpu_torch.tables import build_minsuper, device_tables  # noqa: E402

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", [0, 1])
def test_hash_slots_matches_mix_hash(seed):
    rng = np.random.default_rng(seed)
    n = 4096
    a = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 1 << 32, n, dtype=np.uint64).astype(np.uint32)
    a[:256] = rng.integers(0x8000, 0x10000, 256)  # 16-bit ids with the top bit set
    a[256:260] = [0, 0xFFFFFFFF, 0x7FFFFFFF, 0x80000000]
    want = _mix_hash(a, b)
    at = torch.from_numpy(a.view(np.int32))  # ids arrive as int32 bit patterns
    bt = torch.from_numpy(b.view(np.int32))
    got = TM.hash_slots(at, bt, 0xFFFFFFFF).numpy()
    assert np.array_equal(got, want.astype(np.int64))
    got_m = TM.hash_slots(at, bt, (1 << 19) - 1).numpy()
    assert np.array_equal(got_m, (want & ((1 << 19) - 1)).astype(np.int64))


def test_pack_key_matches_packed_arrays_for_high_ids():
    pairs = {(0x9000, 3): (5, 0x9001), (7, 0xFFFE): (6, 9), (1, 2): (7, 3)}
    pt = build_pair_table(pairs)
    pkey, pval = pt.packed_arrays()
    real = pt.left >= 0
    got = TM.pack_key(torch.from_numpy(pt.left[real]), torch.from_numpy(pt.right[real]))
    assert np.array_equal(got.numpy(), pkey[real])
    assert (pkey[real] < 0).any()  # left id >= 0x8000: a negative int32 key
    slots = np.stack([pkey, pval, np.zeros_like(pkey), np.zeros_like(pkey)], axis=1)
    tab = types.SimpleNamespace(
        pslots=torch.from_numpy(slots),
        probe_len=pt.probe_len, cap_mask=pt.capacity - 1,
    )
    a = torch.tensor([0x9000, 7, 1, 1, -1], dtype=torch.int32)
    b = torch.tensor([3, 0xFFFE, 2, 5, 2], dtype=torch.int32)
    rank, merged = TM.probe_pairs_packed(tab, a, b)
    assert rank.tolist() == [5, 6, 7, TM.INF_RANK, TM.INF_RANK]
    assert merged.tolist() == [0x9001, 9, 3, -1, -1]


@pytest.mark.parametrize("name", ["small", "big-vocab", "big-merges", "charmode"])
def test_probe_pairs_packed_matches_jax(name):
    _ctx, enc = tp.load(name)
    rng = np.random.default_rng(3)
    real = np.array(list(enc.pairs.keys()), dtype=np.int32)
    pick = real[rng.integers(0, len(real), 3000)]
    noise = rng.integers(-1, enc.vocab_size, (3000, 2)).astype(np.int32)
    ab = np.concatenate([pick, noise])
    a, b = ab[:, 0].reshape(60, 100), ab[:, 1].reshape(60, 100)
    want_r, want_m = JM._probe_pairs_packed(
        tp.jax_packed_table(enc), jnp.asarray(a), jnp.asarray(b)
    )
    tab = device_tables(enc, _ctx, "cpu")
    got_r, got_m = TM.probe_pairs_packed(tab, torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(got_r.numpy(), np.asarray(want_r))
    assert np.array_equal(got_m.numpy(), np.asarray(want_m))
    assert (got_r.numpy() < TM.INF_RANK).sum() >= 3000


@pytest.mark.parametrize(
    "name,u16_out", [("small", True), ("big-vocab", False), ("big-merges", True)]
)
def test_merge_words_from_bytes_packed_matches_jax(name, u16_out):
    """Words of 33-128 bytes: the port's eager fixed point."""
    _ctx, enc = tp.load(name)
    rng = np.random.default_rng(5)
    raw, lens = tp.long_word_block(rng, 96, 128, 33)
    lens[:4] = [0, 1, 2, 128]
    want = np.asarray(
        JM.merge_words_from_bytes_packed(
            tp.jax_packed_table(enc), jnp.asarray(enc.byte_seed_ids),
            jnp.asarray(raw), jnp.asarray(lens), u16_out,
        )
    )
    tab = tp.device_tables_cpu(name)
    got = TM.merge_words_from_bytes_packed(
        tab, torch.from_numpy(raw), torch.from_numpy(lens), u16_out
    ).numpy()
    if u16_out:
        got = got.view(np.uint16)
    assert got.dtype == want.dtype
    assert np.array_equal(got, want)
    assert (got[:96].astype(np.int64) < lens).any()  # merges happened


@pytest.mark.parametrize("name", ["charmode", "small"])
def test_merge_words_packed_matches_jax(name):
    """Id blocks (the char-mode path) through the same fixed point."""
    ctx, enc = tp.load(name)
    from hutoken_tpu.pretokenize import encode_remap
    from hutoken_tpu.tables import _seed_elements_of_spelling

    rows = []
    for w in tp.corpus_words():
        spelled = encode_remap(w, ctx.special_chars, None, ctx.is_byte_encoder)
        ids = [ctx.vocab.str2id.get(e) for e in _seed_elements_of_spelling(spelled)]
        if None not in ids and 2 <= len(ids) <= 32:
            rows.append(ids)
    block = np.full((len(rows), 32), -1, dtype=np.int32)
    for i, ids in enumerate(rows):
        block[i, : len(ids)] = ids
    want = np.asarray(JM.merge_words_packed(tp.jax_packed_table(enc), jnp.asarray(block), False))
    got = TM.merge_words_packed(tp.device_tables_cpu(name), torch.from_numpy(block), False)
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("u16_out", [False, True])
def test_compact_output_matches_jax(u16_out):
    rng = np.random.default_rng(9)
    ids = rng.integers(0, 0xFFFF, (64, 16)).astype(np.int32)  # ids >= 0x8000 too
    ids[rng.random((64, 16)) < 0.3] = -1
    want = np.asarray(JM._compact_output(jnp.asarray(ids), jnp.uint16 if u16_out else jnp.int32))
    got = TM.compact_output(torch.from_numpy(ids), u16_out).numpy()
    assert np.array_equal(got.view(np.uint16) if u16_out else got, want)


def _long_chain_ctx():
    """The vocabulary of tests/test_adversarial_vocabs.py::
    test_very_long_tokens, built with the port's classes: GPT-2-spelled
    byte seeds and the prefix chains of b"a" * 80 and b"b" * 600."""
    from hutoken_tpu_torch.bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table
    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.formats import Vocab

    b2u = gpt2_bytes_to_unicode()

    def spell(raw):
        return "".join(b2u[b] for b in raw).encode("utf-8")

    str2id = {spell(bytes([b])): b for b in range(256)}
    nid = 300
    for base in (b"a" * 80, b"b" * 600):
        for ln in range(2, len(base) + 1):
            str2id[spell(base[:ln])] = nid
            nid += 1
    vocab = Vocab(str2id=str2id, id2str={v: k for k, v in str2id.items()},
                  size=max(str2id.values()) + 1)
    sc = {k: v.encode("utf-8") for k, v in gpt2_special_chars_table().items()}
    return TokenizerContext(vocab=vocab, special_chars=sc, is_byte_encoder=True)


def _capped_reference(pairs, id2str, cap):
    """The JAX package's build_minsuper over the pairs spelled in at most
    ``cap`` bytes, and whether that left any pair out."""
    short = {p: v for p, v in pairs.items() if len(id2str[p[0]] + id2str[p[1]]) <= cap}
    return PM.build_minsuper(short, id2str), len(short) < len(pairs)


@pytest.mark.parametrize("name", ["small", "big-vocab", "big-merges", "long-chains"])
def test_build_minsuper_matches_reference(name):
    """Exact against the reference on the pairs that can form inside a
    word the kernels take (spelled in at most the cap), and against the
    full reference where a fixture has no longer spelling; ranks of the
    pairs left out keep 0xFFFF."""
    from hutoken_tpu_torch.tables import build_encoder_tables, minsuper_spelling_cap

    if name == "long-chains":
        ctx = _long_chain_ctx()
        enc = build_encoder_tables(ctx)
    else:
        ctx, enc = tp.load(name)
    id2str = ctx.vocab.id2str
    cap = minsuper_spelling_cap(enc.byte_seed_ids, id2str)
    assert cap == 64  # 32 bytes, each a 1- or 2-byte GPT-2 character
    got = build_minsuper(enc.pairs, id2str, cap)
    want, cut = _capped_reference(enc.pairs, id2str, cap)
    # the string-path fixture holds pairs spelled in more than 64 bytes
    assert want is not None and cut == (name in ("big-vocab", "long-chains"))
    assert np.array_equal(got[: len(want)], want) and (got[len(want):] == 0xFFFF).all()
    if not cut:
        assert np.array_equal(got, PM.build_minsuper(enc.pairs, id2str))
    assert np.array_equal(device_tables(enc, ctx, "cpu").minsuper.numpy(), got)


def test_device_tables_build_fast_on_long_token_chains():
    """The witness of the minutes-long build: device_tables on the
    600-byte prefix chain's vocabulary (about 180k pairs) in under 10 s on
    the CPU; without the spelling cap its bound alone took about 15
    minutes."""
    import time

    from hutoken_tpu_torch.tables import build_encoder_tables

    ctx = _long_chain_ctx()
    enc = build_encoder_tables(ctx)
    assert len(enc.pairs) > 150_000
    t0 = time.perf_counter()
    tab = device_tables(enc, ctx, "cpu")
    assert time.perf_counter() - t0 < 10.0
    assert tab.minsuper is not None and not tab.wide


def _wide_enc(pairs):
    return types.SimpleNamespace(pair_table=build_pair_table(pairs), pairs=pairs, byte_seed_ids=None)


def test_device_tables_build_a_wide_table_for_wide_ids():
    """Ids past 16 bits get the wide [C, 4] table; its probe finds the
    pair and misses the pair its 16-bit truncation would alias."""
    enc = _wide_enc({(70000, 1): (0, 70001)})
    assert not enc.pair_table.packed_ok
    tab = device_tables(enc, None, "cpu")
    assert tab.wide and tab.pslots is None and tuple(tab.slots.shape[1:]) == (4,)
    a = torch.tensor([70000, 70000 & 0xFFFF, 70000, -1], dtype=torch.int32)
    b = torch.tensor([1, 1, 2, 1], dtype=torch.int32)
    rank, merged = TM.probe_pairs(tab, a, b)
    assert rank.tolist() == [0] + [TM.INF_RANK] * 3
    assert merged.tolist() == [70001, -1, -1, -1]


def test_device_tables_refuse_ranks_past_the_kernel_bound():
    """The merge kernel's candidate rank * 32 + lane is 32-bit: a rank of
    2^26 or more is refused, with the reason."""
    device_tables(_wide_enc({(70000, 1): ((1 << 26) - 1, 70001)}), None, "cpu")
    with pytest.raises(ValueError, match="rank 67108864 does not fit the merge kernel"):
        device_tables(_wide_enc({(70000, 1): (1 << 26, 70001)}), None, "cpu")


@pytest.mark.parametrize("name", ["small", "big-vocab", "big-merges", "charmode"])
def test_interleaved_slots_equal_the_packed_arrays(name):
    """The kernels' 16-byte narrow slots hold, slot for slot, the packed
    key and value of the JAX layout and the minsuper bound of the slot's
    rank (0 in empty slots, and everywhere without a bound)."""
    ctx, enc = tp.load(name)
    tab = device_tables(enc, ctx, "cpu")
    pkey, pval = enc.pair_table.packed_arrays()
    slots = tab.pslots.numpy()
    assert slots.shape == (enc.pair_table.capacity, 4) and slots.dtype == np.int32
    assert np.array_equal(slots[:, 0], pkey) and np.array_equal(slots[:, 1], pval)
    real = enc.pair_table.left >= 0
    want_ms = np.zeros(real.shape[0], dtype=np.int32)
    if tab.minsuper is not None:
        want_ms[real] = tab.minsuper.numpy()[enc.pair_table.rank[real]]
        # the reference over the pairs that can form inside a kernel word
        from hutoken_tpu_torch.tables import minsuper_spelling_cap

        id2str = ctx.vocab.id2str
        short, _cut = _capped_reference(enc.pairs, id2str,
                                        minsuper_spelling_cap(enc.byte_seed_ids, id2str))
        ms = np.full(tab.minsuper.shape[0], 0xFFFF, dtype=np.int32)
        ms[: len(short)] = short
        assert np.array_equal(slots[real, 2], ms[enc.pair_table.rank[real]])
    else:
        assert name == "charmode"  # no byte seeds: single-merge rounds
    assert np.array_equal(slots[:, 2], want_ms)
    assert not slots[:, 3].any()
