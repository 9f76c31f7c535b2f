"""The readers of the ``setup`` and ``host`` layers: each on a hand-built
set-up record and span record, the set-up readers' rises adding up to
the high-water mark at the window's first call, each None on an empty
record and on a program that keeps none, and each set-up reader with a
value after one CPU run of the harness."""

from __future__ import annotations

import sys
import types

import pytest

from portbench import harness, registry
from portbench.metrics import _setup, _spans
from tiny import tiny_config, tiny_traffic

torch = pytest.importorskip("torch")
import hutoken_tpu_torch as ht  # noqa: E402
import hutoken_tpu_torch.engine as engine_mod  # noqa: E402
from hutoken_tpu_torch import setup_record  # noqa: E402
from hutoken_tpu_torch.setup_record import SetupRecord, Stamp  # noqa: E402
from hutoken_tpu_torch.spans import SpanRecord  # noqa: E402

CELL = "codeparrot-cpython-shard"
MB = 10**6
S = 10**9

# (name, seconds after the process's start, high-water mark in MB)
STAMPS = [
    ("package", 2.0, 300),
    ("context.start", 3.0, 310), ("context.end", 3.5, 330),
    ("encoder_tables.start", 3.6, 331), ("encoder_tables.end", 3.8, 360),
    ("device_tables.start", 3.8, 360), ("device_tables.end", 5.3, 4300),
    ("replicas.start", 5.3, 4300), ("replicas.end", 5.3, 4300),
    ("id_table.start", 5.4, 4301), ("id_table.end", 5.41, 4303),
    ("decode_fast_path.start", 5.41, 4303), ("decode_fast_path.end", 5.42, 4303),
    ("warmup.start", 6.0, 4500), ("warmup.seg_merge", 6.5, 4520),
    ("warmup.fused_merge", 6.7, 4540), ("warmup.end", 7.0, 4600),
    ("call.1.start", 7.1, 4610), ("call.1.end", 7.6, 4800),
    ("call.2.start", 7.7, 4805), ("call.2.end", 8.2, 4850),
    ("window", 9.0, 4900),
    # after the window: a call no reader counts
    ("call.3.start", 60.0, 5000), ("call.3.end", 60.5, 5100),
]
WANT = {
    "setup.before_program_s": 2.0,
    "setup.before_program_MB": 300,
    "setup.host_build_s": 0.5 + 0.2 + 0.0 + 0.01 + 0.01,
    "setup.host_build_MB": 20 + 29 + 0 + 2 + 0,
    "setup.device_tables_s": 1.5,
    "setup.device_tables_MB": 3940,
    "setup.warmup_s": 1.0,
    "setup.warmup_MB": 100,
    "setup.first_calls_s": 1.0,
    "setup.first_calls_MB": 190 + 45,
}
# the gaps up to the last stamp before the window: package -> context
# 10, context -> encoder_tables 1, replicas -> id_table 1,
# decode_fast_path -> warmup 197, warmup -> call 1 10, call 1 -> call 2
# 5; and apart from them call 2 -> window 50, where a traced run starts
# its profiler
GAPS_MB = 10 + 1 + 1 + 197 + 10 + 5
TO_WINDOW_MB = 50
HOST = {"window.hwm_rise_MB": 12.5, "host.heap_free_MB": 278.0, "host.pinned_MB": 64.0}


def record(stamps=STAMPS, upto: str | None = "call.3.start") -> SetupRecord:
    rec = SetupRecord(start_ns=0)
    for name, t, hwm in stamps:
        if name == upto:
            break
        rec._stamps.append(Stamp(name, int(t * S), hwm * MB, (None,) * 5, None))
    return rec


def span_summary() -> dict:
    return {"spans": {"facade.batch_encode": {"count": 4, "total_s": 1.0, "self_s": 0.5,
                                              "marked": 4, "hwm_rise": 12.5 * MB,
                                              "hwm_rises": 2}},
            "counts": {}, "calls": 4, "dropped": 0,
            "gauges": {"heap_free": 278 * MB, "pinned": 64 * MB, "reads": 1, "cost_s": 1e-4}}


def test_every_reader_of_the_two_layers_is_listed():
    per_layer = registry.load_benchmark()["per_layer"]
    listed = {m["name"] for m in per_layer if m["layer"] in ("setup", "host")}
    assert listed == set(WANT) | set(HOST) | {"setup.gaps_MB"}
    for m in per_layer:
        if m["name"] in listed:
            assert m["workloads"] == [CELL] and m["better"] == "lower"
            s = m["name"].endswith("_s")
            assert m["unit"] == ("s" if s else "MB")
            assert m["source"] == ("program_span" if s else "program_counter")
            assert m["moves"] == ("setup_s" if s else "host_peak_MB")


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_setup_reader_on_a_hand_built_record(name, monkeypatch):
    monkeypatch.setattr(setup_record, "SETUP", record(upto=None))
    assert registry.reader(name)({}) == pytest.approx(WANT[name])


def test_the_setup_rises_add_up_to_the_mark_at_the_window():
    """Before the program, the stages, the gaps between them and the last
    gap before the window: to the byte, the high-water mark at the
    window's first call."""
    s = record().summary()
    assert s["last"] == "window" and s["hwm"] == 4900 * MB
    assert s["gaps"]["hwm_rise"] == GAPS_MB * MB
    assert s["to_window"] == {"seconds": pytest.approx(0.8), "hwm_rise": TO_WINDOW_MB * MB}
    outer = sum(v["hwm_rise"] for v in s["stages"].values() if v["outer"])
    assert (s["before_program"]["hwm_rise"] + outer + s["gaps"]["hwm_rise"]
            + s["to_window"]["hwm_rise"] == s["hwm"])


def test_the_setup_readers_add_up_to_the_mark_at_the_window(monkeypatch):
    monkeypatch.setattr(setup_record, "SETUP", record())
    names = [n for n in WANT if n.endswith("_MB")] + ["setup.gaps_MB"]
    got = {n: registry.reader(n)({}) for n in names}
    assert got["setup.gaps_MB"] == pytest.approx(GAPS_MB)
    assert sum(got.values()) + TO_WINDOW_MB == pytest.approx(4900)


def test_calls_after_the_window_are_not_first_calls(monkeypatch):
    monkeypatch.setattr(setup_record, "SETUP", record(upto=None))
    assert _setup.first_calls("hwm_rise") == pytest.approx(235)
    late = [(n, t, h) for n, t, h in STAMPS if n != "window"]
    monkeypatch.setattr(setup_record, "SETUP", record(late, upto=None))
    assert _setup.first_calls("hwm_rise") == pytest.approx(335)  # no window: every call


@pytest.mark.parametrize("name", sorted(HOST))
def test_a_host_reader_on_a_hand_built_summary(name, monkeypatch):
    monkeypatch.setattr(_spans, "summary", span_summary)
    assert registry.reader(name)({"mb": 2.0}) == pytest.approx(HOST[name])


@pytest.mark.parametrize("name", sorted(WANT) + ["setup.gaps_MB"] + sorted(HOST))
def test_a_reader_on_an_empty_record_is_none(name, monkeypatch):
    monkeypatch.setattr(setup_record, "SETUP", SetupRecord(start_ns=0))
    monkeypatch.setattr(ht, "_get_engine", lambda: types.SimpleNamespace(spans=SpanRecord()))
    assert registry.reader(name)({"mb": 2.0}) is None


def test_a_program_without_the_records_reads_none(monkeypatch):
    """The parent commit's program: no ``setup_record`` module, and a
    span record whose summary lacks the rises and the gauges."""
    monkeypatch.setitem(sys.modules, "hutoken_tpu_torch.setup_record", None)
    summary = span_summary()
    del summary["gauges"]
    del summary["spans"]["facade.batch_encode"]["hwm_rise"]
    monkeypatch.setattr(_spans, "summary", lambda: summary)
    names = sorted(WANT) + ["setup.gaps_MB"] + sorted(HOST)
    assert all(registry.reader(n)({"mb": 2.0}) is None for n in names)


def test_a_cpu_run_of_the_harness_gives_every_setup_reader_a_value(tmp_path, monkeypatch):
    """A fresh record in the program's place: the harness's set-up
    stamps each stage, and its two warm-up calls and the window's
    untraced calls (no profiler on the CPU) are the stamped calls."""
    rec = SetupRecord()
    for owner in (setup_record, engine_mod):
        monkeypatch.setattr(owner, "SETUP", rec)
    monkeypatch.setattr(ht, "_SETUP", rec)
    monkeypatch.setattr(engine_mod, "ROW_BLOCKS", {32: 64, 128: 16})
    cfg, path = tiny_config(tmp_path)
    try:
        ob = harness.run_cell(cfg, path, tiny_traffic(tmp_path), 2**31 + 5, 0.3, False,
                              device="cpu", cache=str(tmp_path / "cache"))
    finally:
        ht._reset()
    assert ob.check["correct"]
    s = rec.summary()
    assert {"context", "encoder_tables", "device_tables", "replicas", "id_table",
            "decode_fast_path", "warmup", "call.1", "call.2"} <= set(s["stages"])
    assert all(st["pinned"] is None for st in s["stamps"])  # a CPU engine
    names = sorted(WANT) + ["setup.gaps_MB"]
    got = {n: registry.reader(n)({}) for n in names}
    assert all(v is not None and v >= 0 for v in got.values()), got
    assert got["setup.host_build_s"] > 0 and got["setup.first_calls_s"] > 0
    mb = sum(v for n, v in got.items() if n.endswith("_MB"))
    assert mb * MB == pytest.approx(s["hwm"], abs=1)
