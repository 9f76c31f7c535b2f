"""The id merge (hutoken_tpu_torch/ops/id_merge.py): its plain PyTorch
twin, which the wrapper runs for CPU tensors, against the JAX package's
merge fixed point (``merge_words_packed``, ``merge_words_from_bytes_packed``
and ``merge_words``) on the char-mode, big-vocab and wide tables and on
hand-built rules ranked past 2^24, on corpus rows and on edge blocks
(``scripts/profile_merge.py::edge_block``, held to the greedy order
too); the generated char-mode vocabulary
through the port's engine against the JAX engine and the oracle; the
CUDA kernel against the twin on the card.  Token ids are integers:
every comparison is exact (tolerance 0)."""

import os
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import torch_parity as tp  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu.context import TokenizerContext  # noqa: E402
from hutoken_tpu.ops import merge as JM  # noqa: E402
from hutoken_tpu.tables import build_encoder_tables, build_pair_table  # noqa: E402
from hutoken_tpu_torch import corpora as C  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.ops import build as B  # noqa: E402
from hutoken_tpu_torch.ops import id_merge as IM  # noqa: E402
from hutoken_tpu_torch.ops import merge as TM  # noqa: E402
from hutoken_tpu_torch.scripts import profile_merge as PM  # noqa: E402
from hutoken_tpu_torch.tables import device_tables  # noqa: E402

torch.set_num_threads(1)
WIDTHS = [8, 16, 32, 64, 128]
TABLES = ["charmode", "big-vocab", "wide"]
# the wide table's ids pass 16 bits: the engine never asks it for 16-bit output
OUTPUTS = [(name, u16) for name in TABLES for u16 in (True, False) if not (u16 and name == "wide")]
BYTE_OUTPUTS = [(name, u16) for name in ("big-vocab", "big-merges", "wide") for u16 in (True, False)
                if not (u16 and name == "wide")]
ROWS = 40


@pytest.fixture(scope="module")
def tables(tmp_path_factory):
    """name -> (port DeviceTables on the CPU, JAX table tuple, byte seeds
    or None, id pool for the rows), each built once; ``.rules[name]`` is
    the table's rules {(left, right): (rank, merged)}."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        if name == "wide":
            v, s, m = tp.write_wide_fixture(str(tmp_path_factory.mktemp("wide")))
            ctx = TokenizerContext.load(v, s, is_byte_encoder=True, merges_file_path=m)
            enc = build_encoder_tables(ctx)
        else:
            ctx, enc = tp.load(name)
        tab = device_tables(enc, ctx, "cpu")
        assert tab.wide == (name == "wide")
        if tab.wide:
            pt = enc.pair_table
            jtab = (jnp.asarray(pt.left), jnp.asarray(pt.right), jnp.asarray(pt.rank),
                    jnp.asarray(pt.merged), pt.probe_len, pt.capacity - 1, JM.MODE_PROBE)
        else:
            jtab = tp.jax_packed_table(enc)
        built[name] = (tab, jtab, enc.byte_seed_ids, _pool(name, ctx, enc))
        get.rules[name] = enc.pairs
        return built[name]

    get.rules = {}
    return get


def _pool(name, ctx, enc) -> np.ndarray:
    """The seed ids of the fixture corpus's words in corpus order: the
    byte seeds in byte mode, the char-mode seed elements of each
    remapped word (as the engine seeds it) otherwise."""
    words = [w for w in tp.corpus_words() if w.startswith(b" ")]
    if enc.byte_seed_ids is not None:
        return enc.byte_seed_ids[np.frombuffer(b"".join(words), dtype=np.uint8)].astype(np.int32)
    seeder = E.TorchTokenizer(ctx, device="cpu")
    seeds = [seeder._seed_word(w, False) for w in words]
    return np.concatenate([s for s in seeds if s is not None]).astype(np.int32)


def _rows(pool: np.ndarray, width: int, seed: int) -> np.ndarray:
    """int32 [ROWS, width] cut from the pool, lengths 1..width, PAD
    after; rows 0-2 all PAD, rows 3-5 one id, rows 6-8 full width, row 9
    with a PAD inside, row 10 random ids of the pool."""
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, width + 1, ROWS)
    lens[:3], lens[3:6], lens[6:9] = 0, 1, width
    block = np.full((ROWS, width), -1, dtype=np.int32)
    for i, n in enumerate(lens):
        st = int(rng.integers(0, len(pool) - width))
        block[i, :n] = pool[st: st + n]
    if width > 2:
        block[9, width // 2] = -1
    block[10] = pool[rng.integers(0, len(pool), width)]
    return block


def _word_block(pool_bytes: bytes, width: int, seed: int):
    rng = np.random.default_rng(seed)
    lens = rng.integers(max(1, width // 2), width + 1, ROWS).astype(np.int32)
    lens[:2] = [0, 1]
    raw = np.zeros((ROWS, width), dtype=np.uint8)
    for i, n in enumerate(lens):
        st = int(rng.integers(0, len(pool_bytes) - width))
        raw[i, :n] = np.frombuffer(pool_bytes[st: st + n], dtype=np.uint8)
    return raw, lens


def _as_u16(x: np.ndarray, u16: bool) -> np.ndarray:
    return x.view(np.uint16) if u16 else x


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name,u16", OUTPUTS)
def test_id_merge_matches_jax_merge_words_packed(name, u16, width, tables):
    """Id blocks in the packed layout, on the CPU through the wrapper,
    against the JAX ``merge_words_packed`` (interpreted on the CPU)."""
    tab, jtab, _seed, pool = tables(name)
    block = _rows(pool, width, seed=width)
    want = _as_u16(np.asarray(JM.merge_words_packed(jtab, jnp.asarray(block), u16)), u16)
    calls = TM.merge_fixed_point.calls
    got = IM.id_merge(tab, torch.from_numpy(block), u16)
    assert TM.merge_fixed_point.calls == calls + 1
    assert got.dtype == (torch.int16 if u16 else torch.int32)
    got = _as_u16(got.numpy(), u16)
    assert np.array_equal(got, want)
    counts = got[:ROWS].astype(np.int64)
    assert counts[:3].tolist() == [0, 0, 0] and counts[3:6].tolist() == [1, 1, 1]
    assert (counts[6:] < (block[6:] >= 0).sum(axis=1)).any()  # rows merged


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name", TABLES)
def test_id_merge_padded_matches_jax_merge_words(name, width, tables):
    """The padded layout (the sharded merge's) against JAX ``merge_words``."""
    tab, jtab, _seed, pool = tables(name)
    block = _rows(pool, width, seed=100 + width)
    want = np.asarray(JM.merge_words(jtab, jnp.asarray(block)))
    got = IM.id_merge(tab, torch.from_numpy(block), True, padded=True)
    assert got.dtype == torch.int32 and tuple(got.shape) == block.shape
    assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("width", WIDTHS)
@pytest.mark.parametrize("name,u16", BYTE_OUTPUTS)
def test_id_merge_bytes_matches_jax(name, u16, width, tables):
    """Byte words of up to 128 bytes against JAX
    ``merge_words_from_bytes_packed`` and the oracle."""
    tab, jtab, seeds, _pool = tables(name)
    pool = b"".join(w.strip() for w in tp.corpus_words())
    raw, lens = _word_block(pool, width, seed=200 + width)
    want = _as_u16(np.asarray(JM.merge_words_from_bytes_packed(
        jtab, jnp.asarray(seeds.astype(np.int32)), jnp.asarray(raw), jnp.asarray(lens), u16)), u16)
    got = _as_u16(IM.id_merge_bytes(tab, torch.from_numpy(raw), torch.from_numpy(lens), u16).numpy(), u16)
    assert np.array_equal(got, want)
    if name != "wide":
        ctx, _enc = tp.load(name)
        for i, toks in enumerate(tp.unpack(got, ROWS)[:12]):
            assert toks == (oracle.encode_word(ctx, bytes(raw[i, : lens[i]]), None) if lens[i] else [])


@pytest.mark.parametrize("width", [32, 64, 128])
def test_high_rank_rules_match_jax(width):
    """Hand-built rules ranked 2^24 .. 2^26 - 1 (a rank * 128 + position
    key would overflow 32 bits) with each row's lowest-ranked pair at a
    position of 32 or more: the wide table's twin against JAX
    ``merge_words_packed`` and ``merge_words``."""
    rm = C.high_rank_rules()
    rules, marker = rm
    assert min(r for r, _m in rules.values()) == C.HIGH_RANK and rules[marker][0] == C.HIGH_RANK
    # rows cut to 32 ids lose the marker: the tile path
    block = np.ascontiguousarray(C.high_rank_block(rm, ROWS, max(width, 34), seed=width)[:, :width])
    enc = types.SimpleNamespace(pair_table=build_pair_table(rules), pairs=rules, byte_seed_ids=None)
    tab = device_tables(enc, None, "cpu")
    assert tab.wide
    pt = enc.pair_table
    jtab = (jnp.asarray(pt.left), jnp.asarray(pt.right), jnp.asarray(pt.rank),
            jnp.asarray(pt.merged), pt.probe_len, pt.capacity - 1, JM.MODE_PROBE)
    want = np.asarray(JM.merge_words_packed(jtab, jnp.asarray(block), False))
    got = IM.id_merge(tab, torch.from_numpy(block), False).numpy()
    assert np.array_equal(got, want)
    assert (got[:ROWS] < width).all()  # every row merged
    padded = IM.id_merge(tab, torch.from_numpy(block), False, padded=True).numpy()
    assert np.array_equal(padded, np.asarray(JM.merge_words(jtab, jnp.asarray(block))))


def _high_rank_tables():
    """(rules, port DeviceTables on the CPU, JAX wide table tuple) of
    ``corpora.high_rank_rules``."""
    rules, _marker = C.high_rank_rules()
    enc = types.SimpleNamespace(pair_table=build_pair_table(rules), pairs=rules, byte_seed_ids=None)
    pt = enc.pair_table
    jtab = (jnp.asarray(pt.left), jnp.asarray(pt.right), jnp.asarray(pt.rank),
            jnp.asarray(pt.merged), pt.probe_len, pt.capacity - 1, JM.MODE_PROBE)
    return rules, device_tables(enc, None, "cpu"), jtab


def _greedy(rules: dict, row: np.ndarray) -> list[int]:
    """The sequential greedy order on one padded id row: merge the
    leftmost lowest-ranked pair with no PAD side until none has a rule;
    the freed tail is PAD."""
    ids = [int(x) for x in row]
    while True:
        best = None
        for i in range(len(ids) - 1):
            hit = rules.get((ids[i], ids[i + 1])) if ids[i] >= 0 and ids[i + 1] >= 0 else None
            if hit is not None and (best is None or hit[0] < best[0]):
                best = (hit[0], i, hit[1])
        if best is None:
            return ids
        _r, i, m = best
        ids = ids[:i] + [m] + ids[i + 2:] + [-1]


@pytest.mark.parametrize("width", PM.EDGE_WIDTHS)
@pytest.mark.parametrize("name", TABLES + ["high-rank"])
def test_edge_blocks_match_jax_and_greedy(name, width, tables):
    """``profile_merge.edge_block`` rows (the first merge at p = 0 and at
    the row's last pair, PAD at both ends and inside, one id or one pair
    repeated over the row, rows that merge to one id, an all-PAD row, a
    one-id row) at widths on both sides of 32, 64 and 128, through the
    wrapper on the CPU, packed and padded, against JAX
    ``merge_words_packed`` / ``merge_words`` and the greedy order."""
    if name == "high-rank":
        rules, tab, jtab = _high_rank_tables()
    else:
        tab, jtab, _seed, _pool = tables(name)
        rules = tables.rules[name]
    block = PM.edge_block(rules, width, seed=width)
    want = np.asarray(JM.merge_words(jtab, jnp.asarray(block)))
    padded = IM.id_merge(tab, torch.from_numpy(block), False, padded=True).numpy()
    assert np.array_equal(padded, want)
    assert padded.tolist() == [_greedy(rules, r) for r in block]
    packed = IM.id_merge(tab, torch.from_numpy(block), False).numpy()
    assert np.array_equal(packed, np.asarray(JM.merge_words_packed(jtab, jnp.asarray(block), False)))
    counts = (padded >= 0).sum(axis=1)
    assert counts[9] == 0 and counts[10] == 1
    assert (counts[3:5] <= (width + 1) // 2).all()  # every pair of the repeat merged
    assert (counts[5:9] == 1).any()  # a row merged to one id
    a, b = block[0, :2]
    assert padded[0, 0] == rules[(a, b)][1] and (block[1, -2:] == [a, b]).all()


@pytest.mark.parametrize("width", PM.EDGE_WIDTHS)
def test_repeated_byte_words_match_jax_and_oracle(width, tables):
    """Byte words of one repeated letter ("t" x 128 and shorter: "tt" is
    a rule of both tables, so every pair has one rank and the leftmost
    wins; "a" and " ", whose pairs have none) and of a repeated pair
    ("le"), through ``id_merge_bytes`` against JAX
    ``merge_words_from_bytes_packed`` and the oracle."""
    words = [c * n for c in (b"t", b"a", b" ", b"le") for n in (width // len(c), width // 2, 2)]
    raw = np.zeros((len(words), width), dtype=np.uint8)
    lens = np.array([len(w) for w in words], dtype=np.int32)
    for i, w in enumerate(words):
        raw[i, : len(w)] = np.frombuffer(w, dtype=np.uint8)
    for name in ("big-vocab", "big-merges"):
        tab, jtab, seeds, _pool = tables(name)
        want = np.asarray(JM.merge_words_from_bytes_packed(
            jtab, jnp.asarray(seeds.astype(np.int32)), jnp.asarray(raw), jnp.asarray(lens), False))
        got = IM.id_merge_bytes(tab, torch.from_numpy(raw), torch.from_numpy(lens), False).numpy()
        assert np.array_equal(got, want)
        ctx, _enc = tp.load(name)
        rows = tp.unpack(got, len(words))
        assert rows == [oracle.encode_word(ctx, w, None) for w in words]
        assert len(rows[0]) <= (width + 1) // 2  # every pair of "t" x width merged


def test_high_rank_block_puts_the_minimum_past_32():
    rm = C.high_rank_rules()
    rules, (ma, mb) = rm
    block = C.high_rank_block(rm, 64, 128, seed=3)
    at = np.argmax(block == ma, axis=1)
    assert (at >= 32).all() and (block[np.arange(64), at + 1] == mb).all()
    assert ((block == ma).sum(axis=1) == 1).all()
    ranks = [r for (a, b), (r, _m) in rules.items() if a < ma and b < ma]
    assert min(ranks) > rules[(ma, mb)][0] >= 1 << 24


def test_id_merge_empty_and_rejects():
    tab = tp.device_tables_cpu("charmode")
    out = IM.id_merge(tab, torch.zeros((0, 16), dtype=torch.int32), False)
    assert tuple(out.shape) == (0,)
    with pytest.raises(ValueError, match="at most 128"):
        IM.id_merge(tab, torch.zeros((2, 129), dtype=torch.int32), False)
    with pytest.raises(ValueError, match="int32"):
        IM.id_merge(tab, torch.zeros((2, 8), dtype=torch.int64), False)
    with pytest.raises(ValueError, match="byte-level table"):
        IM.id_merge_bytes(tab, torch.zeros((2, 8), dtype=torch.uint8),
                          torch.zeros(2, dtype=torch.int32), False)
    btab = tp.device_tables_cpu("big-vocab")
    with pytest.raises(ValueError, match="lens"):
        IM.id_merge_bytes(btab, torch.zeros((2, 8), dtype=torch.uint8),
                          torch.zeros(3, dtype=torch.int32), False)


def test_words_per_block():
    assert [IM.words_per_block(w) for w in (1, 8, 9, 16, 17, 32, 33, 64, 128)] == [
        32, 32, 32, 32, 32, 32, 8, 8, 8]


def test_id_merge_digests_its_shared_header():
    files = B.kernel_files(os.path.join(B.CSRC, "id_merge.cu"))
    assert [os.path.basename(f) for f in files] == ["id_merge.cu", "merge_warp.cuh"]
    assert all(os.path.exists(f) for f in files)


# ------------------------------------------------ the char-mode fixture


@pytest.fixture(scope="module")
def char_fixture(tmp_path_factory):
    return C.write_char_fixture(str(tmp_path_factory.mktemp("char")))


def test_char_fixture_vocabulary(char_fixture):
    from hutoken_tpu_torch.context import TokenizerContext as PortContext
    from hutoken_tpu_torch.tables import build_encoder_tables as port_tables, max_token_id

    v, s = char_fixture
    ctx = PortContext.load(v, s, is_byte_encoder=False)
    ids = ctx.vocab.str2id
    assert len(ctx.vocab.id2str) == C.CHAR_VOCAB_SIZE == 32000
    assert all(ids[f"<0x{b:02X}>".encode()] == b for b in range(256))
    assert ids["▁".encode()] == 256
    assert all(c.encode() in ids for c in set(C.BASE_TEXT) if not c.isspace())
    assert max_token_id(ctx.vocab) < 0xFFFF
    tab = device_tables(port_tables(ctx), ctx, "cpu")
    assert not tab.wide and tab.byte_seed is None and tab.minsuper is None
    assert C.write_char_fixture(os.path.dirname(v)) == (v, s)
    with open(v, "rb") as f:
        first = f.read()
    C.write_char_fixture(os.path.dirname(v))
    with open(v, "rb") as f:
        assert f.read() == first  # deterministic


def test_char_fixture_engine_matches_jax_and_oracle(char_fixture, monkeypatch):
    """40 documents of the Zipf corpus through the port's engine on the
    CPU (blocks cut small, so the id merge's twin runs) against the JAX
    engine and the oracle, with no prefix (the pipelined core) and with
    the "▁" prefix."""
    from hutoken_tpu.engine import TpuTokenizer
    from hutoken_tpu_torch.context import TokenizerContext as PortContext

    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    v, s = char_fixture
    docs = C.build_corpus(0.1)[:40]
    assert len(docs) == 40
    for prefix in (None, "▁"):
        ctx = PortContext.load(v, s, prefix=prefix, is_byte_encoder=False)
        jctx = TokenizerContext.load(v, s, prefix=prefix, is_byte_encoder=False)
        calls = TM.merge_fixed_point.calls
        tok = E.TorchTokenizer(ctx, device="cpu")
        got = tok.encode_batch(docs)
        assert got == TpuTokenizer(jctx).encode_batch(docs)
        assert got == [oracle.encode(jctx, d) for d in docs]
        assert TM.merge_fixed_point.calls > calls and tok.stat_device_words > 0


# ------------------------------------------------------------ the card


@pytest.mark.cuda
@pytest.mark.parametrize("name", TABLES + ["high-rank"])
def test_kernel_matches_twin_on_cuda(name, tables):
    """The kernel against the twin at every width, packed (both output
    types on narrow tables) and padded, on the edge blocks
    (``profile_merge.edge_block``) at widths 31-128, and on byte words;
    "high-rank" is the hand-built wide rules ranked from 2^24."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    if name == "high-rank":
        rm = C.high_rank_rules()
        rules, tab, _jtab = _high_rank_tables()
        seeds = None
        blocks = [C.high_rank_block(rm, ROWS, width, seed=width) for width in (34, 64, 128)]
    else:
        tab, _jtab, seeds, pool = tables(name)
        rules = tables.rules[name]
        blocks = [_rows(pool, width, seed=width) for width in WIDTHS]
    blocks += [PM.edge_block(rules, width, seed=width) for width in PM.EDGE_WIDTHS]
    dtab = tab.to("cuda")
    for rows in blocks:
        block = torch.from_numpy(rows).cuda()
        W = block.shape[0]
        for u16 in ((False,) if tab.wide else (True, False)):
            want = TM.merge_words_packed(dtab, block, u16)
            read = W + int(want[:W].to(torch.int64).sum())
            launches = IM.id_merge.launches + IM.id_merge.wide_launches
            got = IM.id_merge(dtab, block, u16)
            torch.cuda.synchronize()
            assert IM.id_merge.launches + IM.id_merge.wide_launches == launches + 1
            assert torch.equal(got[:read], want[:read])
        assert torch.equal(IM.id_merge(dtab, block, False, padded=True), TM.merge_fixed_point(dtab, block))
    if seeds is not None:
        for width in WIDTHS:
            raw, lens = _word_block(b"".join(w.strip() for w in tp.corpus_words()), width, seed=width)
            r, n = torch.from_numpy(raw).cuda(), torch.from_numpy(lens).cuda()
            want = TM.merge_words_from_bytes_packed(dtab, r, n, False)
            read = ROWS + int(want[:ROWS].sum())
            assert torch.equal(IM.id_merge_bytes(dtab, r, n, False)[:read], want[:read])
