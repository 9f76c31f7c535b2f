"""The port's span record (hutoken_tpu_torch/spans.py) on the CPU twins:
nothing is kept without a profiler and the ids do not change with one;
a traced call's span tree, its worker threads' spans included; the
counts of where a call's new words went, against the engine's lifetime
counters; the ids the facade's lists hold; the clock shared with the
profiler's Chrome trace; the raw path's stages; and the cap."""

import json
import threading
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

import fixture_tools as ft  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
from hutoken_tpu import oracle  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch.setup_record import heap_arenas  # noqa: E402
from hutoken_tpu_torch.spans import RECORD, SpanRecord  # noqa: E402

torch.set_num_threads(1)

STAGES = {"engine.route", "engine.split_intern", "engine.split_wait", "engine.resolve",
          "engine.launch", "engine.device_wait", "engine.host_tail", "engine.tail_wait",
          "engine.assemble"}
RAW_STAGES = {"producer", "find_cut", "alphabet", "main_wait", "launch", "nonzero_sync",
              "copy_wait", "splice", "assembly"}


@pytest.fixture(autouse=True)
def _small_blocks_and_a_clean_record(monkeypatch):
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    hutoken._reset()
    RECORD.clear()
    yield
    hutoken._reset()
    RECORD.clear()


def _docs():
    """Enough new words for full blocks of both buckets and a host tail,
    one-byte words and words past 128 bytes."""
    words = ft.CORPUS.split()
    docs = [" ".join(words[i : i + 40]) for i in range(0, len(words), 40)]
    docs += [f"q{i}x{'ab' * (i % 30)} z{i}" for i in range(300)]
    docs += ["x " + "y" * 300 + " ! ?", "", " a b c"]
    return docs


def _init(**kw):
    vocab_path, special_path = ft.write_byte_level_fixture()
    hutoken.initialize(vocab_path, special_path, is_byte_encoder=True, device="cpu", **kw)


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        return fn()


def test_untraced_calls_keep_nothing_and_equal_a_traced_call():
    _init()
    docs = _docs()
    plain = hutoken.batch_encode(docs)
    hutoken._get_engine().reset_cache()
    assert RECORD.spans() == [] and RECORD.summary()["calls"] == 0
    traced = _traced(lambda: hutoken.batch_encode(docs))
    assert RECORD.summary()["calls"] == 1
    assert traced == plain
    assert plain == [oracle.encode(hutoken._ctx, d) for d in docs]


def test_a_traced_call_records_the_span_tree(tmp_path):
    _init()
    hutoken._get_engine()  # built outside the traced call
    docs = _docs()
    main = threading.get_native_id()
    _traced(lambda: hutoken.batch_encode(docs))
    spans = RECORD.spans()
    by_name = {}
    for s in spans:
        by_name.setdefault(s.name, []).append(s)
    assert set(by_name) == {"facade.batch_encode", "engine.encode_core"} | STAGES
    (facade,), (core,) = by_name["facade.batch_encode"], by_name["engine.encode_core"]
    assert facade.parent == 0 and core.parent == facade.sid
    assert {s.call for s in spans} == {facade.call}
    for name in STAGES:
        for s in by_name[name]:
            assert s.parent == core.sid, name
            assert core.start_ns <= s.start_ns <= s.end_ns <= core.end_ns, name
    workers = {"engine.split_intern", "engine.host_tail"}
    assert all(s.tid != main for n in workers for s in by_name[n])
    assert all(s.tid == main for n in STAGES - workers for s in by_name[n])
    assert facade.start_ns <= core.start_ns <= core.end_ns <= facade.end_ns
    summary = RECORD.summary()["spans"]
    assert summary["engine.encode_core"]["self_s"] < summary["engine.encode_core"]["total_s"]

    # the Chrome export: one tid a thread, the call id in args
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": [], "baseTimeNanoseconds": facade.start_ns}))
    assert RECORD.append_to_chrome_trace(str(path)) == len(spans)
    events = json.loads(path.read_text())["traceEvents"]
    assert {e["args"]["call"] for e in events} == {facade.call}
    assert {e["tid"] for e in events} == {s.tid for s in spans}
    first = next(e for e in events if e["name"] == "facade.batch_encode")
    assert first["ph"] == "X" and first["ts"] == 0 and first["dur"] > 0


def _core_counts():
    return [s.counts for s in RECORD.spans() if s.name == "engine.encode_core"]


@pytest.mark.parametrize("calls", [1, 2], ids=["cold", "then-warm"])
def test_counts_are_conserved_on_every_call(calls):
    _init()
    eng = hutoken._get_engine()
    docs = _docs()
    moved = []
    for i in range(calls):
        w0, b0 = eng.stat_device_words, eng.stat_device_bytes
        _traced(lambda: hutoken.batch_encode(docs[i:]))
        moved.append((eng.stat_device_words - w0, eng.stat_device_bytes - b0))
    counts = _core_counts()
    assert len(counts) == calls
    for c, (words_moved, bytes_moved) in zip(counts, moved):
        assert c["path.pipelined"] == 1
        for unit in ("words", "bytes"):
            parts = sum(c.get(f"{unit}.{x}", 0) for x in ("single", "device", "host_tail", "long"))
            assert parts == c.get(f"{unit}.new", 0), (unit, c)
        assert c.get("words.device", 0) == words_moved
        assert c.get("bytes.device", 0) == bytes_moved
        assert c["words"] >= c.get("words.new", 0)
    cold = counts[0]
    assert cold["words.new"] > 0 and cold["words.device"] > 0 and cold["words.single"] > 0
    assert cold["words.host_tail"] > 0 and cold["words.long"] > 0
    # every device word's bytes went up, in padded rows and lengths
    assert cold["bytes.h2d"] > cold["bytes.device"]
    if calls == 2:
        assert counts[1].get("words.new", 0) < cold["words.new"]


@pytest.mark.parametrize("case", ["byte-level", "prefix-run"])
def test_the_facade_counts_the_ids_it_lists(case):
    """``ids.listed`` and ``ids.shared`` ride on ``facade.batch_encode``:
    every id of the lists, the prefix run's included, is one of the id
    table's objects, so the two are equal, and equal to the lists'
    lengths."""
    if case == "byte-level":
        _init()
        docs = _docs()
    else:
        vocab_path, special_path = ft.write_char_mode_fixture()
        hutoken.initialize(vocab_path, special_path, prefix="\u2581", is_byte_encoder=False,
                           device="cpu")
        docs = [" " + " ".join(w for w in d.split() if w.isascii()) for d in _docs()[:20]]
    out = _traced(lambda: hutoken.batch_encode(docs))
    (facade,) = [s for s in RECORD.spans() if s.name == "facade.batch_encode"]
    listed = sum(map(len, out))
    assert listed > 0
    assert facade.counts["ids.listed"] == facade.counts["ids.shared"] == listed
    assert RECORD.summary()["counts"]["ids.listed"] == listed
    if case == "prefix-run":
        assert hutoken._get_engine()._prefix_token_run()


def test_the_host_backend_counts_its_path():
    _init(backend="host")
    docs = ["a host call", " and another"]
    assert _traced(lambda: hutoken.batch_encode(docs)) == [oracle.encode(hutoken._ctx, d) for d in docs]
    (facade,) = RECORD.spans()
    counts = dict(facade.counts)
    if heap_arenas() is not None:  # glibc: the first traced call is watched
        assert counts.pop("heap.arenas") >= 1
    assert facade.name == "facade.batch_encode" and counts == {"path.host": 1}
    assert hutoken._engine is None


def test_spans_share_the_profiler_trace_clock(tmp_path):
    """Each span contains the range opened inside it; the closest of five
    tries is within 50 us on each side (one try can meet a context switch
    on a busy host; a clock off the trace's would miss by far more)."""
    tries = 5
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("warm-up"):
            pass
        for _ in range(tries):
            with RECORD.entry("clock.outer"):
                with record_function("clock.inner"):
                    time.sleep(0.002)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    assert RECORD.append_to_chrome_trace(path) == tries
    events = json.load(open(path, encoding="utf-8"))["traceEvents"]
    inner = sorted(e["ts"] for e in events if e.get("name") == "clock.inner")
    outer = sorted(e["ts"] for e in events if e.get("name") == "clock.outer")
    ends = {name: sorted(e["ts"] + e["dur"] for e in events if e.get("name") == name)
            for name in ("clock.inner", "clock.outer")}
    assert len(inner) == len(outer) == tries
    assert all(e["cat"] == "hutoken" for e in events if e.get("name") == "clock.outer")
    leads = [i - o for i, o in zip(inner, outer)]
    lags = [o - i for i, o in zip(ends["clock.inner"], ends["clock.outer"])]
    assert min(leads) >= 0 and min(lags) >= 0, (leads, lags)
    assert min(leads) <= 50 and min(lags) <= 50, (leads, lags)


def test_the_raw_path_records_its_stages(monkeypatch):
    monkeypatch.setenv("HUTOKEN_TPU_RAW", "1")
    monkeypatch.setenv("HUTOKEN_TPU_RAW_C", "8192")
    import torch_parity as tp

    ctx, _enc = tp.load("small")
    tok = E.TorchTokenizer(ctx, device="cpu")
    # a document past a chunk (a cut), words past 32 bytes (a splice),
    # all in the raw program's alphabet
    text = " ".join(w for w in ft.CORPUS.split() if w.isascii())
    docs = [(text + " ") * (1 + 20000 // len(text)), "short " + "w" * 40 + " end", "plain"]
    main = threading.get_native_id()
    got = _traced(lambda: tok.encode_batch(docs))
    assert got == [oracle.encode(ctx, d) for d in docs]
    spans = RECORD.spans()
    names = {s.name for s in spans}
    assert {f"engine.raw.{k}" for k in RAW_STAGES} <= names
    (core,) = [s for s in spans if s.name == "engine.encode_core"]
    assert core.counts["path.raw"] == 1 and core.counts["words.device"] > 0
    assert {s.call for s in spans} == {core.call}
    by_sid = {s.sid: s for s in spans}
    for s in spans:
        if s.name in ("engine.raw.find_cut", "engine.raw.alphabet"):
            assert by_sid[s.parent].name == "engine.raw.producer"
        elif s.name != "engine.encode_core":
            assert s.parent == core.sid, s.name
    assert all(s.tid != main for s in spans
               if s.name in ("engine.raw.producer", "engine.raw.copy_wait"))


def test_the_cap_counts_dropped_spans():
    rec = SpanRecord(cap=3)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with rec.entry("call") as span:
                span.count("n", 2)
    s = rec.summary()
    assert len(rec.spans()) == 3 and s["dropped"] == 2 and s["calls"] == 3
    assert s["spans"]["call"]["count"] == 3 and s["counts"] == {"n": 6}
    rec.clear()
    assert rec.spans() == [] and rec.summary()["dropped"] == 0


def test_self_time_subtracts_the_union_of_same_thread_children():
    rec = SpanRecord()
    with profile(activities=[ProfilerActivity.CPU]):
        with rec.entry("root") as root:
            a = root.child("a")
            b = root.child("b")
            other = []
            t = threading.Thread(target=lambda: other.append(root.child("worker")))
            t.start()
            t.join()
    # fixed times (ns): root 0-100, a 10-40 and b 30-60 on the root's
    # thread, the worker 0-100 on another
    for span, lo, hi in ((root, 0, 100), (a, 10, 40), (b, 30, 60), (other[0], 0, 100)):
        span.start_ns, span.end_ns = lo, hi
    rec._spans = [root, a, b, other[0]]
    s = rec.summary()["spans"]
    assert s["root"]["total_s"] == pytest.approx(100e-9)
    assert s["root"]["self_s"] == pytest.approx(50e-9)
    assert s["a"]["self_s"] == pytest.approx(30e-9)
