"""The wide table's cell: the per-layer metrics it reports, the reader
that only it lists on a hand-built record and None on an empty one, the
kernel's share read on a window of wide launches, one CPU run of the
harness and of the engine on the ``deepseek-v3-128k-py`` configuration
that stamps the wide table's stage and gives the reader a value, and the
build script, which writes the committed vocabulary again where this
machine holds the corpus it records."""

from __future__ import annotations

import json
import os
import shutil
import sysconfig
import types

import pytest

from portbench import harness, registry
from portbench.gen import build_deepseek_v3_py as build
from portbench.gen.files import load_sample
from tiny import SAMPLE, tiny_traffic

torch = pytest.importorskip("torch")
import hutoken_tpu_torch as ht  # noqa: E402
import hutoken_tpu_torch.engine as engine_mod  # noqa: E402
import hutoken_tpu_torch.tables as tables_mod  # noqa: E402
from hutoken_tpu_torch import setup_record  # noqa: E402
from hutoken_tpu_torch.setup_record import SetupRecord  # noqa: E402
from hutoken_tpu_torch.spans import RECORD, SpanRecord  # noqa: E402
from portbench.metrics import _spans  # noqa: E402

BENCH = registry.load_benchmark()
CELL = "deepseek-v3-cpython-shard"
OLD_CELL = "codeparrot-cpython-shard"
CONFIG = "deepseek-v3-128k-py"
NEW = ["engine.d2h_bytes_per_device_id"]
# the layers whose accepted metrics both cells report; those of the set-up
# and host layers are listed on the narrow cell alone
SHARED_LAYERS = ("entry", "facade", "engine", "kernels", "device")
WORK = {"launches": 2, "in_bytes": 3_000_000, "out_ids": 1_000_000, "device_s": 0.001}
SHARE = 100 * (3e6 + 4e6) / 3.35e12 / 0.001


def test_the_cell_reports_the_shared_layers_and_its_own_reader():
    per_layer = BENCH["per_layer"]
    shared = [m["name"] for m in per_layer if m["layer"] in SHARED_LAYERS and m["name"] not in NEW]
    assert len(shared) == 19
    assert all(m["workloads"] == [OLD_CELL, CELL] for m in per_layer if m["name"] in shared)
    assert all(m["workloads"] == [CELL] for m in per_layer if m["name"] in NEW)
    assert [m["name"] for m in registry.metrics_of(BENCH, CELL, True)] == shared + NEW
    assert [m.KERNEL for m in registry.kernel_readers(BENCH, CELL)] == ["fused_merge"]
    assert registry.cell(BENCH, CELL)["config"] == CONFIG


def test_the_copy_back_reader_on_a_hand_built_summary(monkeypatch):
    summary = {"spans": {}, "counts": {"bytes.d2h": 800, "ids.device": 50}, "calls": 1}
    monkeypatch.setattr(_spans, "summary", lambda: summary)
    assert registry.reader("engine.d2h_bytes_per_device_id")({}) == pytest.approx(16.0)
    summary["counts"] = {"bytes.d2h": 800}  # a program that counts no ids
    assert registry.reader("engine.d2h_bytes_per_device_id")({}) is None


def test_the_share_counts_the_wide_launches(monkeypatch):
    """``fused_merge_roofline`` counts the launches of both variants, so
    a window of wide launches alone reads the wide kernel's share."""
    from hutoken_tpu_torch.ops.fused_merge import merge_words_from_bytes_fused as fm

    monkeypatch.setattr(fm, "launches", 0)
    monkeypatch.setattr(fm, "wide_launches", 2)
    mod = registry.kernel_readers(BENCH, CELL)[0]
    assert mod.launches() == 2
    obs = {"kernels": {"fused_merge": dict(WORK)}, "peak_bytes_per_s": 3.35e12}
    assert registry.reader("fused_merge_roofline")(obs) == pytest.approx(SHARE)


@pytest.mark.parametrize("name", NEW)
def test_a_reader_on_an_empty_record_is_none(name, monkeypatch):
    monkeypatch.setattr(setup_record, "SETUP", SetupRecord(start_ns=0))
    monkeypatch.setattr(ht, "_get_engine", lambda: types.SimpleNamespace(spans=SpanRecord()))
    assert registry.reader(name)({"mb": 2.0}) is None


def test_a_cpu_run_gives_the_program_readers_a_value(tmp_path, monkeypatch):
    """A fresh set-up record, blocks of 64 words, the configuration's own
    files and the tiny traffic: the harness's run is correct and stamps
    the wide table's stage within ``device_tables``; a call under a CPU
    profiler counts what it copied back, 4 bytes an entry."""
    from torch.profiler import ProfilerActivity, profile

    rec = SetupRecord()
    for owner in (setup_record, engine_mod, tables_mod):
        monkeypatch.setattr(owner, "SETUP", rec)
    monkeypatch.setattr(ht, "_SETUP", rec)
    monkeypatch.setattr(engine_mod, "ROW_BLOCKS", {32: 64, 128: 16})
    cfg, path = registry.config(BENCH, CONFIG)
    docs = [d[:1500] for d in load_sample(SAMPLE)[:12]]
    RECORD.clear()
    try:
        ob = harness.run_cell(cfg, path, tiny_traffic(tmp_path), 2**31 + 7, 0.3, False,
                              device="cpu", cache=str(tmp_path / "cache"))
        ht._get_engine().reset_cache()
        with profile(activities=[ProfilerActivity.CPU]):
            ht.batch_encode(docs)
        per_id = registry.reader("engine.d2h_bytes_per_device_id")({})
    finally:
        RECORD.clear()
        ht._reset()
    assert ob.check["correct"]
    summary = rec.summary()
    stage = summary["stages"]["device_tables.wide_table"]
    assert stage["seconds"] > 0 and not stage["outer"] and summary["stages"]["device_tables"]["outer"]
    assert summary["notes"]["pair_table"]["wide"]
    assert per_id >= 4


def test_the_vocabulary_is_the_recipe_run_on_the_recorded_corpus(tmp_path, monkeypatch):
    """Where this machine's ``site-packages`` gives the corpus whose
    SHA-256 the configuration records, the build script writes the
    committed files again, byte for byte, the configuration's record
    included."""
    pytest.importorskip("tokenizers")
    site = sysconfig.get_paths()["purelib"]
    with open(build.CONFIG, encoding="utf-8") as f:
        recorded = json.load(f)["train_corpus"]
    if not os.path.isdir(site) or build.corpus_record(build.corpus_files(site)) != {
            k: recorded[k] for k in ("files", "bytes", "sha256")}:
        pytest.skip("this machine's site-packages is not the recorded corpus")
    config = tmp_path / f"{CONFIG}.json"
    shutil.copyfile(build.CONFIG, config)
    monkeypatch.setattr(build, "CONFIG", str(config))
    monkeypatch.setattr(build, "VOCAB_DIR", str(tmp_path / "vocab"))
    assert build.main(["--site", site]) == 0
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(build.VOCAB_DIR, name), "rb") as a, \
                open(os.path.join(registry.PKG, "configs", CONFIG, name), "rb") as b:
            assert a.read() == b.read(), name
    with open(config, "rb") as a, open(os.path.join(registry.PKG, "configs", f"{CONFIG}.json"),
                                       "rb") as b:
        assert a.read() == b.read()
