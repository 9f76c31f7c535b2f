"""BENCHMARK.json and the files it names: the shape the format requires, and each
piece found by its name, so that an added file needs no edit elsewhere."""

from __future__ import annotations

import json
import os
import re
import shutil

import pytest

from portbench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
BENCH = registry.load_benchmark()
# the facade's options for a vocabulary file (``hutoken_tpu_torch.initialize``)
# but ``merges_file_path``, which the harness passes from the writer's files
INITIALIZE = {"is_byte_encoder", "prefix", "pattern", "token_id"}


def line_ok(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert os.path.isdir(os.path.join(registry.ROOT, p))
    assert len(BENCH["command"]) <= 32 and all(line_ok(w) for w in BENCH["command"])
    assert len(json.dumps(BENCH).encode()) <= 64 << 10


def test_configs():
    used = {w["config"] for w in BENCH["workloads"]}
    names = [c["name"] for c in BENCH["configs"]]
    assert len(names) == len(set(names)) and set(names) == used
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith(BENCH["paths"][0] + "/")
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])
        cfg, _path = registry.config(BENCH, c["name"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert cfg["source"] == c["source"] and set(c["reduced"]) <= set(cfg)
        assert cfg["table"] in ("narrow", "wide") and cfg["assumed"]
        assert callable(registry.named(cfg["files"]["writer"], "gen"))
        assert callable(registry.named(cfg["reference"], "reference"))
        initialize_is_stated(cfg)


def initialize_is_stated(cfg: dict) -> None:
    """The options that ``initialize`` and the reference take: among the
    facade's, and the mode always stated (the facade's default is char
    mode, the byte-mode reference's is byte mode)."""
    assert set(cfg["initialize"]) <= INITIALIZE and "is_byte_encoder" in cfg["initialize"]


def test_cells():
    names = [w["name"] for w in BENCH["workloads"]]
    assert 1 <= len(names) <= 24 and len(names) == len(set(names))
    pairs = {(w["config"], w["traffic"]) for w in BENCH["workloads"]}
    assert len(pairs) == len(names)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(names) // 4)
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and line_ok(w["why"])
        assert w["chips"] in (1, 4)
        t = registry.traffic(w["traffic"])
        assert callable(registry.named(t["generator"], "gen")) and t["check_calls"] >= 2
        assert t["warmup_calls"] >= 1


def test_metrics():
    e2e = BENCH["end_to_end"]
    names = [m["name"] for m in e2e + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    assert "setup_s" in {m["name"] for m in e2e}
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in e2e:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert callable(registry.reader(m["name"]))
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        reader = registry.reader_module(m["name"])
        if hasattr(reader, "ENTRY"):  # a kernel's reader says what the tracer wraps
            assert all(callable(getattr(reader, f)) for f in ("keep", "launches", "work"))
            assert reader.KERNEL and ":" in reader.ENTRY
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {x["name"] for x in e2e} and line_ok(m["layer"])
        assert callable(registry.reader(m["name"]))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in e2e + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for c in cells:
        assert "setup_s" in [m["name"] for m in registry.metrics_of(BENCH, c, False)]
        assert len(registry.metrics_of(BENCH, c, False)) >= 2
        assert registry.metrics_of(BENCH, c, True)


def test_files_under_paths_are_named_from_name_characters():
    for base, _dirs, files in os.walk(registry.PKG):
        if "__pycache__" in base or ".cache" in base:
            continue
        for f in files:
            rel = os.path.relpath(os.path.join(base, f), registry.ROOT)
            assert re.match(r"^[A-Za-z0-9_./-]+$", rel), rel


def test_an_added_mix_generator_and_metric_need_no_edit(tmp_path):
    pkg = tmp_path / "bench"
    shutil.copytree(registry.PKG, pkg, ignore=shutil.ignore_patterns(".cache", "__pycache__", "data"))
    (pkg / "traffic" / "short-mix.json").write_text(json.dumps(
        {"generator": "short:docs", "docs_per_call": 4, "reset_per_pass": True,
         "warmup_calls": 1, "check_calls": 2, "check_docs": 2}))
    (pkg / "gen" / "short.py").write_text(
        "def docs(traffic, seed):\n    return [str(seed)] * traffic['docs_per_call']\n")
    (pkg / "metrics" / "new.per_MB.py").write_text(
        "def read(obs):\n    return obs['mb'] * 2\n")
    t = registry.traffic("short-mix", pkg=str(pkg))
    assert registry.named(t["generator"], "gen", pkg=str(pkg))(t, 9) == ["9"] * 4
    assert registry.reader("new.per_MB", pkg=str(pkg))({"mb": 1.5}) == 3.0
    with pytest.raises(registry.BenchError):
        registry.traffic("absent-mix", pkg=str(pkg))
    with pytest.raises(registry.BenchError):
        registry.reader("absent.metric", pkg=str(pkg))
    with pytest.raises(registry.BenchError):
        registry.named("absent:docs", "gen", pkg=str(pkg))


def test_metrics_of_filters_by_workloads():
    bench = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
             "per_layer": [{"name": "c", "workloads": ["y"]}]}
    assert [m["name"] for m in registry.metrics_of(bench, "x", False)] == ["a", "b"]
    assert [m["name"] for m in registry.metrics_of(bench, "y", False)] == ["a"]
    assert [m["name"] for m in registry.metrics_of(bench, "y", True)] == ["c"]
    assert registry.metrics_of(bench, "x", True) == []
