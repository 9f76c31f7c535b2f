"""The engine's table of shared ids (``hutoken_tpu_torch/id_table.py``):
``IdTable.take`` gives the values of the ids in both layouts, growing
the table for ids it lacks; and ``TorchTokenizer.encode_batch`` builds
its lists from the table, so that equal ids are one object, on the
dense table (a byte-level vocabulary) and the sorted one (ids 70,000 /
70,001 on 258 lines), while the values stay those of
``encode_batch_arrays`` and no call's lists share a list with another's.

The engine's blocks are cut to 64 / 16 rows so that the small batches
reach the device path."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.bytemaps import gpt2_bytes_to_unicode, gpt2_special_chars_table  # noqa: E402
from hutoken_tpu_torch.context import TokenizerContext  # noqa: E402
from hutoken_tpu_torch.formats import write_special_chars_file, write_vocab_file  # noqa: E402
from hutoken_tpu_torch.id_table import DENSE_SPAN, IdTable  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _small_blocks(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)


def _values_and_identity(table, ids):
    got = table.take(np.asarray(ids, dtype=np.int32)).tolist()
    assert got == list(ids) and all(type(x) is int for x in got)
    again = table.take(np.asarray(ids, dtype=np.int32)).tolist()
    assert all(a is b for a, b in zip(got, again))
    return got


# ------------------------------------------------------------ the table


def test_dense_layout_holds_every_id_up_to_the_top_and_minus_one():
    table = IdTable(range(1000))
    assert table.dense and len(table.objs) == 1001
    _values_and_identity(table, [999, 300, -1, 0, 256, 257, 999, -1])
    assert table.take(np.zeros(0, dtype=np.int32)).shape == (0,)


def test_sorted_layout_past_the_dense_span():
    ids = list(range(256)) + [70000, 70001]
    table = IdTable(ids)
    assert not table.dense and len(table.objs) == len(ids) + 1  # and -1
    _values_and_identity(table, [70001, 70000, 5, -1, 70001])
    # the span's edge: the top id at DENSE_SPAN x the ids is dense, one past is not
    n = 100
    assert IdTable(list(range(n - 1)) + [DENSE_SPAN * (n + 1) - 2]).dense
    assert not IdTable(list(range(n - 1)) + [DENSE_SPAN * (n + 1) - 1]).dense


def test_ids_in_the_billions_allocate_no_holes():
    table = IdTable([0, 1, 3_000_000_000])
    assert not table.dense and len(table.objs) == 4
    assert table.take(np.array([3_000_000_000, 1, -1], dtype=np.int64)).tolist() == [
        3_000_000_000, 1, -1]


@pytest.mark.parametrize("layout", ["dense", "sorted"])
def test_ids_past_the_table_grow_it(layout):
    ids = list(range(500)) if layout == "dense" else [0, 1, 90_000]
    table = IdTable(ids)
    assert table.dense == (layout == "dense")
    got = _values_and_identity(table, [1, 700, 700, -1, 0])
    assert 700 in table.keys.tolist() and got[1] is got[2]
    # an id below -1 is kept too, in the sorted layout
    _values_and_identity(table, [-7, 1, 700, -7])
    assert not table.dense and -7 in table.keys.tolist()


# ---------------------------------------------------- the engine's lists


def _byte_level():
    v, s = ft.write_byte_level_fixture()
    ctx = TokenizerContext.load(v, s, is_byte_encoder=True)
    words = ft.CORPUS.split()
    docs = [" ".join(words[i : i + 40]) for i in range(0, len(words), 40)]
    return ctx, docs + docs[:5]


def _id_holes(tmp_path):
    b2u = gpt2_bytes_to_unicode()
    id2str = {b: b2u[b].encode("utf-8") for b in range(256)}
    id2str[70000], id2str[70001] = b"he", b"hel"
    vpath, spath = str(tmp_path / "holes-vocab.txt"), str(tmp_path / "holes-special.txt")
    write_vocab_file(vpath, id2str)
    write_special_chars_file(spath, gpt2_special_chars_table())
    rng = random.Random(0)
    words = ["hel" + "".join(rng.choice("abcdefgxyz") for _ in range(rng.randint(1, 8)))
             for _ in range(600)]
    docs = [" ".join(words[i : i + 30]) for i in range(0, 600, 30)]
    return TokenizerContext.load(vpath, spath, is_byte_encoder=True), docs + docs[:3]


@pytest.mark.parametrize("layout", ["dense", "sorted"])
def test_encode_batch_shares_one_object_an_id(layout, tmp_path):
    ctx, docs = _byte_level() if layout == "dense" else _id_holes(tmp_path)
    tok = E.TorchTokenizer(ctx, device="cpu")
    assert tok._id_table.dense == (layout == "dense")
    got = tok.encode_batch(docs)
    assert tok.stat_device_words > 0
    flat, offs = tok.encode_batch_arrays(docs)
    assert [x for t in got for x in t] == flat.tolist()
    assert [len(t) for t in got] == np.diff(offs).tolist()
    objects: dict[int, set] = {}
    for t in got:
        for x in t:
            objects.setdefault(x, set()).add(id(x))
    repeated = [v for v in objects if v > 256 and sum(t.count(v) for t in got) > 1]
    assert len(repeated) > 10 if layout == "dense" else repeated == [70001]
    assert all(len(objects[v]) == 1 for v in objects)
    vocab_ids = set(ctx.vocab.id2str) | set(ctx.vocab.str2id.values())
    assert len(objects) <= len(vocab_ids) and set(objects) <= vocab_ids
    # the next call hands out the same objects in fresh lists
    before = [list(t) for t in got]
    got[0].append(-5)
    got[1][0] = 12345
    got[2].clear()
    tok.reset_cache()
    again = tok.encode_batch(docs)
    assert again == before
    assert all(a is not b for a, b in zip(again, got))
    v = repeated[0]
    assert all(x is next(y for t in before for y in t if y == v)
               for t in again for x in t if x == v)
