"""The traffic sample and the vocabulary are what the configuration and
the build script state, the pools follow the seed, and the files hutoken
loads are written once."""

from __future__ import annotations

import json
import os

import pytest

from portbench import harness, registry
from portbench.gen import build_codeparrot_py as build
from portbench.gen.files import load_sample
from portbench.pool import make_pool
from tiny import port_context

BENCH = registry.load_benchmark()


def test_the_sample_is_the_half_of_the_library_the_build_script_takes():
    with open(build.SAMPLE, encoding="utf-8") as f:
        rows = [json.loads(line) for line in f]
    paths = [r["path"] for r in rows]
    assert len(rows) == 355 and paths == sorted(paths)
    assert all(p.startswith("Lib/") and p.endswith(".py") for p in paths)
    assert all(build.in_sample(p[len("Lib/"):]) for p in paths)
    assert all(r["content"].strip() and "\x00" not in r["content"] for r in rows)
    assert sum(len(r["content"].encode()) for r in rows) == 5_796_781
    assert os.path.isfile(os.path.join(registry.PKG, "data", "cpython-LICENSE.txt"))


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_pool_is_deterministic_from_the_seed(cell):
    t = registry.traffic(registry.cell(BENCH, cell)["traffic"])
    a = make_pool(t, 2**31 + 5)
    b = make_pool(t, 2**31 + 5)
    c = make_pool(t, 2**31 + 6)
    assert a.batches == b.batches and a.call_bytes == b.call_bytes
    assert a.batches != c.batches
    # every seed takes the same documents and bytes, in another order
    assert sorted(d for x in a.batches for d in x) == sorted(d for x in c.batches for d in x)
    assert a.nbytes == c.nbytes
    assert a.call_bytes == [sum(len(d.encode()) for d in x) for x in a.batches]
    assert make_pool(t, -7).batches == make_pool(t, -7).batches
    assert make_pool(t, 2**40 + 1).nbytes == a.nbytes


def test_calls_cut_in_order_with_a_shorter_last(tmp_path):
    sample = tmp_path / "s.jsonl"
    sample.write_text("".join(json.dumps({"path": str(i), "content": f"doc {i}"}) + "\n"
                              for i in range(7)))
    t = {"generator": "files:documents", "sample": str(sample), "docs_per_call": 3}
    p = make_pool(t, 1)
    assert [len(b) for b in p.batches] == [3, 3, 1]
    assert sorted(d for b in p.batches for d in b) == load_sample(str(sample))


def vocabulary_files_are_as_stated(cfg: dict, path: str, cache: str) -> None:
    """The writer's files, cached, loaded with the configuration's own
    options: as many ids and rules as it states, the table it states, and
    the prefix it states a token of the vocabulary."""
    from hutoken_tpu_torch.tables import max_token_id

    files = harness.vocab_files(cfg, path, cache=cache)
    with open(files["vocab"], encoding="utf-8") as f:
        assert sum(1 for _ in f) == cfg["vocab_size"]
    stamp = os.path.getmtime(files["vocab"])
    assert harness.vocab_files(cfg, path, cache=cache) == files  # cached
    assert os.path.getmtime(files["vocab"]) == stamp
    ctx = port_context(cfg, files)
    narrow = max_token_id(ctx.vocab) < 0xFFFF
    assert (cfg["table"] == "narrow") == narrow
    assert ctx.prefix is None or ctx.prefix in ctx.vocab.str2id
    if files["merges"] is None:  # pairs ranked by the id of their join
        assert cfg["merges"] == 0 and ctx.merges is None
        return
    with open(files["merges"], encoding="utf-8") as f:
        lines = f.read().splitlines()[1:]  # below the "#version" header
    assert len(lines) == cfg["merges"]
    # hutoken skips every line that starts with "#" as a comment, rules too
    assert ctx.merges.num_rules == sum(not line.startswith("#") for line in lines)


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_vocabulary_files(tmp_path, name):
    cfg, path = registry.config(BENCH, name)
    vocabulary_files_are_as_stated(cfg, path, str(tmp_path))


def test_the_vocabulary_is_the_recipe_run_on_the_rest_of_the_library(tmp_path, monkeypatch):
    """Where this machine has CPython 3.12.12's library and ``tokenizers``,
    the build script writes the committed files again, byte for byte."""
    import sys
    import sysconfig

    pytest.importorskip("tokenizers")
    lib = sysconfig.get_paths()["stdlib"]
    if sys.version_info[:3] != (3, 12, 12) or not os.path.isfile(os.path.join(lib, "LICENSE.txt")):
        pytest.skip("needs CPython 3.12.12's library")
    monkeypatch.setattr(build, "SAMPLE", str(tmp_path / "data" / "sample.jsonl"))
    monkeypatch.setattr(build, "VOCAB_DIR", str(tmp_path / "vocab"))
    monkeypatch.setattr(build, "PKG", str(tmp_path))
    assert build.main(["--lib", lib]) == 0
    for name in ("vocab.json", "merges.txt"):
        with open(os.path.join(build.VOCAB_DIR, name), "rb") as a, \
                open(os.path.join(registry.PKG, "configs", "codeparrot-py-32k", name), "rb") as b:
            assert a.read() == b.read(), name
    with open(build.SAMPLE, "rb") as a, \
            open(os.path.join(registry.PKG, "data", "cpython-3.12.12-lib.jsonl"), "rb") as b:
        assert a.read() == b.read()
