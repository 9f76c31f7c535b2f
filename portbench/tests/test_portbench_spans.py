"""The readers of the program's own spans and counts: each on a
hand-built summary, each None on an empty record and on a program that
keeps none, and every one with a value after one CPU run of the engine
under a CPU profiler."""

from __future__ import annotations

import types

import pytest

from portbench import harness, registry
from portbench.metrics import _spans
from tiny import SAMPLE, tiny_config

torch = pytest.importorskip("torch")
import hutoken_tpu_torch as ht  # noqa: E402
import hutoken_tpu_torch.engine as engine_mod  # noqa: E402
from hutoken_tpu_torch.spans import RECORD, SpanRecord  # noqa: E402

MB = 2.0


def stage(total, self_s=None):
    return {"count": 3, "total_s": total, "self_s": total if self_s is None else self_s}


SUMMARY = {
    "spans": {
        "facade.batch_encode": stage(0.9, 0.3), "engine.encode_core": stage(0.6, 0.01),
        "engine.route": stage(0.002), "engine.split_intern": stage(0.2),
        "engine.split_wait": stage(0.1), "engine.resolve": stage(0.05),
        "engine.launch": stage(0.04), "engine.device_wait": stage(0.003),
        "engine.host_tail": stage(0.03), "engine.tail_wait": stage(0.02),
        "engine.assemble": stage(0.08), "engine.reset_cache": stage(0.006),
    },
    "counts": {"words": 1000, "words.new": 250, "bytes.new": 2000, "bytes.device": 1800,
               "bytes.h2d": 5400, "bytes.d2h": 3600, "ids.device": 900},
    "calls": 3, "dropped": 0,
}
WANT = {
    "facade.self_ms_per_MB": 1e3 * 0.3 / MB,
    "engine.route_ms_per_MB": 1e3 * 0.002 / MB,
    "engine.split_intern_ms_per_MB": 1e3 * 0.2 / MB,
    "engine.split_wait_ms_per_MB": 1e3 * 0.1 / MB,
    "engine.resolve_ms_per_MB": 1e3 * 0.05 / MB,
    "engine.launch_ms_per_MB": 1e3 * 0.04 / MB,
    "engine.device_wait_ms_per_MB": 1e3 * 0.003 / MB,
    "engine.host_tail_ms_per_MB": 1e3 * 0.03 / MB,
    "engine.tail_wait_ms_per_MB": 1e3 * 0.02 / MB,
    "engine.assemble_ms_per_MB": 1e3 * 0.08 / MB,
    "engine.reset_ms_per_MB": 1e3 * 0.006 / MB,
    "engine.new_word_share": 0.25,
    "engine.device_byte_share": 0.9,
    "engine.upload_bytes_per_device_byte": 3.0,
    "engine.d2h_bytes_per_device_id": 4.0,
}


def test_every_reader_of_the_record_is_listed():
    """The readers of the encode path's spans and counts; those of the
    ``setup`` and ``host`` layers are ``test_portbench_setup.py``'s."""
    listed = {m["name"] for m in registry.load_benchmark()["per_layer"]
              if m["source"] in ("program_span", "program_counter")
              and m["layer"] not in ("setup", "host")
              and m["name"] not in ("facade.ms_per_MB", "engine.ms_per_MB")}
    assert listed == set(WANT)


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_on_a_hand_built_summary(name, monkeypatch):
    monkeypatch.setattr(_spans, "summary", lambda: SUMMARY)
    assert registry.reader(name)({"mb": MB}) == pytest.approx(WANT[name])
    if name.endswith("_ms_per_MB"):
        assert registry.reader(name)({"mb": 0}) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_a_reader_on_an_empty_record_is_none(name, monkeypatch):
    monkeypatch.setattr(ht, "_get_engine", lambda: types.SimpleNamespace(spans=SpanRecord()))
    assert registry.reader(name)({"mb": MB}) is None


def test_a_program_without_the_record_reads_none(monkeypatch):
    monkeypatch.setattr(ht, "_get_engine", lambda: types.SimpleNamespace())
    assert all(registry.reader(name)({"mb": MB}) is None for name in WANT)


def test_one_cpu_run_under_a_cpu_profiler_gives_every_reader_a_value(tmp_path, monkeypatch):
    """Blocks of 64 words, so that the tiny batch's new words reach the
    fused kernel's twin and leave a host tail; the batch is cut to its
    first 12 files of 1,500 characters."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.gen.files import load_sample

    monkeypatch.setattr(engine_mod, "ROW_BLOCKS", {32: 64, 128: 16})
    cfg, path = tiny_config(tmp_path)
    files = harness.vocab_files(cfg, path, str(tmp_path / "cache"))
    ht.initialize(files["vocab"], files["special"], merges_file_path=files["merges"],
                  device="cpu", **cfg["initialize"])
    docs = [d[:1500] for d in load_sample(SAMPLE)[:12]]
    RECORD.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for _ in range(2):
                ht._get_engine().reset_cache()
                ht.batch_encode(docs)
        mb = 2 * sum(len(d.encode()) for d in docs) / 1e6
        got = {name: registry.reader(name)({"mb": mb}) for name in WANT}
    finally:
        RECORD.clear()
        ht._reset()
    assert all(v is not None and v > 0 for v in got.values()), got
    assert 0 < got["engine.new_word_share"] < 1 and 0 < got["engine.device_byte_share"] < 1
    assert got["engine.upload_bytes_per_device_byte"] > 1
