"""The benchmark's 128,000-id byte-level vocabulary (``deepseek-v3-128k-py``,
``portbench/configs/``) through the port's facade on the CPU twins: ids
equal to the benchmark's plain reference on documents of its traffic
sample, the wide pair table (ids past 16 bits, no multi-merge bound),
the set-up record's stage around the wide table's rebuild and its note
of the table's shape, and the counts of what a traced call copies back
from the card.  Blocks are cut to 64 / 16 rows so that a few documents
reach the fused kernel's twin.  Token ids are integers: every
comparison is exact."""

import random

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import hutoken_tpu_torch as hutoken  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import setup_record  # noqa: E402
from hutoken_tpu_torch import tables as T  # noqa: E402
from hutoken_tpu_torch.setup_record import SetupRecord  # noqa: E402
from hutoken_tpu_torch.spans import RECORD  # noqa: E402
from portbench import harness, registry  # noqa: E402
from portbench.gen.files import load_sample  # noqa: E402

torch.set_num_threads(1)
CONFIG = "deepseek-v3-128k-py"
HIGH = 0x10000  # the first id a 16-bit packed table cannot hold
SEED = 23


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    cfg, path = registry.config(registry.load_benchmark(), CONFIG)
    return cfg, harness.vocab_files(cfg, path, cache=str(tmp_path_factory.mktemp("cache")))


@pytest.fixture(scope="module")
def docs():
    sample = load_sample(f"{registry.PKG}/data/cpython-3.12.12-lib.jsonl")
    return random.Random(SEED).sample(sample, 8)


@pytest.fixture
def rec(monkeypatch):
    """A fresh set-up record in the package's place, a clean span
    record, and small blocks."""
    r = SetupRecord()
    for owner in (setup_record, E, T):
        monkeypatch.setattr(owner, "SETUP", r)
    monkeypatch.setattr(hutoken, "_SETUP", r)
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    hutoken._reset()
    RECORD.clear()
    yield r
    hutoken._reset()
    RECORD.clear()


def _init(files):
    cfg, f = files
    hutoken.initialize(f["vocab"], f["special"], merges_file_path=f["merges"], device="cpu",
                       **cfg["initialize"])
    return hutoken._get_engine()


def test_the_port_equals_the_plain_reference(files, docs, rec):
    engine = _init(files)
    launched = engine.stat_shard_fused[0]
    got = hutoken.batch_encode(docs)
    assert engine.stat_shard_fused[0] > launched  # the fused kernel's twin ran
    ref = harness.reference(*files)
    assert got == [ref.encode(d) for d in docs]
    assert any(i >= HIGH for ids in got for i in ids)


def test_the_engine_takes_the_wide_table(files, rec):
    engine = _init(files)
    tab = engine.dev_tables
    assert tab.wide and tab.minsuper is None and tab.pslots is None
    assert not engine._u16_out
    shape = rec.summary()["notes"]["pair_table"]
    assert shape == {"wide": True, "slots": tab.cap_mask + 1, "probe_len": tab.probe_len,
                     "minsuper": False}
    assert shape["slots"] >= 128000 and shape["probe_len"] <= T.WIDE_MAX_PROBE


def test_the_wide_rebuild_is_a_stage_within_device_tables(files, rec):
    _init(files)
    names = [s.name for s in rec.stamps()]
    i = names.index("device_tables.start")
    assert names[i : i + 4] == ["device_tables.start", "device_tables.wide_table.start",
                                "device_tables.wide_table.end", "device_tables.end"]
    stages = rec.summary()["stages"]
    assert not stages["device_tables.wide_table"]["outer"] and stages["device_tables"]["outer"]
    assert 0 < stages["device_tables.wide_table"]["seconds"] <= stages["device_tables"]["seconds"]


def test_set_up_builds_one_host_pair_table(files, rec, monkeypatch):
    """One host pair table, the wide one at the probe bound
    ``WIDE_MAX_PROBE`` (524,288 slots, probe bound 10), and no table of
    the default bound of 4 (4,194,304 slots), which the wide path never
    read; the set-up note ``host_pair_tables`` lists it alone."""
    built, build = [], T.build_pair_table

    def spy(pairs, max_probe_len=4):
        pt = build(pairs, max_probe_len)
        built.append((max_probe_len, pt.capacity))
        return pt

    monkeypatch.setattr(T, "build_pair_table", spy)
    engine = _init(files)
    assert built == [(T.WIDE_MAX_PROBE, 524288)]
    assert rec.summary()["notes"]["host_pair_tables"] == [524288]
    assert engine.dev_tables.shape() == {"wide": True, "slots": 524288, "probe_len": 10,
                                         "minsuper": False}
    assert engine.tables.pair_table is None


@pytest.mark.parametrize("name", ["codeparrot-py-32k", CONFIG])
def test_the_engine_uploads_the_tables_of_the_copy(name, tmp_path):
    """On both benchmark configurations the tables the engine's builder
    puts on the device are, element for element, those ``device_tables``
    makes from the copied builder's tables (the narrow configuration's
    probe-4 table, the wide one's rebuild); the narrow one keeps that
    table on the host, as before."""
    from hutoken_tpu_torch.context import TokenizerContext

    cfg, path = registry.config(registry.load_benchmark(), name)
    f = harness.vocab_files(cfg, path, cache=str(tmp_path / "cache"))
    ctx = TokenizerContext.load(f["vocab"], f["special"], merges_file_path=f["merges"],
                                **cfg["initialize"])
    enc, copy_enc = T.build_engine_tables(ctx), T.build_encoder_tables(ctx)
    got, want = T.device_tables(enc, ctx, "cpu"), T.device_tables(copy_enc, ctx, "cpu")
    assert got.wide == (cfg["table"] == "wide") and got.shape() == want.shape()
    for field in ("pslots", "slots", "byte_seed", "minsuper"):
        a, b = getattr(got, field), getattr(want, field)
        assert (a is None and b is None) or (a.dtype == b.dtype and torch.equal(a, b)), field
    if got.wide:
        assert enc.pair_table is None and copy_enc.pair_table.capacity == 4194304
    else:
        assert enc.pair_table.capacity == copy_enc.pair_table.capacity == 1048576


def test_a_traced_call_counts_what_the_card_sent_back(files, docs, rec):
    engine = _init(files)
    plain = hutoken.batch_encode(docs)
    assert RECORD.summary()["counts"] == {}  # an untraced call counts nothing
    engine.reset_cache()
    with profile(activities=[ProfilerActivity.CPU]):
        traced = hutoken.batch_encode(docs)
    assert traced == plain
    (counts,) = [s.counts for s in RECORD.spans() if s.name == "engine.encode_core"]
    ids_on_card = counts["ids.device"]
    assert 0 < ids_on_card <= sum(map(len, traced))
    # int32 entries: each device word's count, then its token bound of slots
    assert counts["bytes.d2h"] % 4 == 0
    assert counts["bytes.d2h"] == 4 * (counts["words.device"] + counts["bytes.device"])
    assert ids_on_card <= counts["bytes.device"]
