"""A configuration in another encode mode is added as new files alone.

A copy of the harness under a temporary directory takes a char-mode
configuration (SentencePiece style: ``is_byte_encoder`` false, the "▁"
prefix, ``<0xNN>`` byte tokens) as new files: a tiny vocabulary, its
writer under ``gen/`` (``char_writer.py``), its reference under
``reference/`` (``char_standin.py``), the configuration, its traffic
and a ``BENCHMARK.json`` that lists it with one cell.  Found the way the
harness finds them, the cell runs ``correct`` on the CPU twins, its
control reads not correct, ``bpe:Reference`` refuses it, and the
per-configuration tests pass on it and fail on broken copies of it.

The stand-in reference takes the port's own word split and remap: this
checks the plumbing, not char mode's semantics.
"""

from __future__ import annotations

import collections
import functools
import json
import re
import shutil

import pytest

from portbench import control, harness, registry
from portbench.gen.files import load_sample
from test_portbench_gen import vocabulary_files_are_as_stated
from test_portbench_layout import initialize_is_stated
from test_portbench_reference import reference_equals_the_ports_oracle
from tiny import tiny_traffic

torch = pytest.importorskip("torch")
import hutoken_tpu_torch as ht  # noqa: E402
import hutoken_tpu_torch.engine as engine_mod  # noqa: E402

CONFIG = "tiny-char"
CELL = "tiny-char.tiny"
MARK = "▁"
# SentencePiece's space mark, and the whitespace controls to their byte tokens
SPECIALS = {32: MARK, 10: "<0x0A>", 13: "<0x0D>", 9: "<0x09>"}
VOCAB_SIZE = 640
_named = registry.named


def char_tokens(docs: list[str]) -> list[str]:
    """Tokens in id order: the 256 ``<0xNN>`` byte tokens, "▁", the
    printable ASCII characters, then the prefix chains of the documents'
    most frequent words, with and without "▁", shortest first, to
    ``VOCAB_SIZE`` ids.  Every longer token is a token and one character."""
    tokens = [f"<0x{b:02X}>" for b in range(256)] + [MARK]
    tokens += [chr(c) for c in range(0x21, 0x7F)]
    known = set(tokens)
    counts = collections.Counter(w for d in docs for w in re.findall(r"[A-Za-z_]{3,}", d))
    words = [w for w, _n in counts.most_common(60)]
    for ln in range(2, 12):
        for w in words:
            for cand in ((MARK + w)[:ln], w[:ln]):
                if len(cand) == ln and cand not in known:
                    known.add(cand)
                    tokens.append(cand)
                    if len(tokens) == VOCAB_SIZE:
                        return tokens
    raise ValueError(f"the words give only {len(tokens)} tokens")


@pytest.fixture
def added(tmp_path, monkeypatch):
    """The copy with the configuration's files added (root, its
    ``BENCHMARK.json``); ``registry.named`` looks in the copy."""
    root = tmp_path / "root"
    pkg = root / "portbench"
    shutil.copytree(registry.PKG, pkg,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__", "data"))
    shutil.copy(pkg / "tests" / "char_writer.py", pkg / "gen" / "char_writer.py")
    shutil.copy(pkg / "tests" / "char_standin.py", pkg / "reference" / "char_standin.py")
    traffic = tiny_traffic(tmp_path)
    (pkg / "traffic" / "tiny-mix.json").write_text(json.dumps(traffic))
    vocab_dir = pkg / "configs" / CONFIG
    vocab_dir.mkdir()
    tokens = char_tokens(load_sample(traffic["sample"]))
    (vocab_dir / "vocab.txt").write_text("".join(
        "".join(f"0x{b:02X}" for b in t.encode()) + f" == {i}\n" for i, t in enumerate(tokens)),
        encoding="utf-8")
    (vocab_dir / "special_chars.txt").write_text(
        "".join(f"{b} == {c}\n" for b, c in SPECIALS.items()), encoding="utf-8")
    cfg = {"name": CONFIG, "source": "a test vocabulary in a SentencePiece model's char mode",
           "reduced": [], "assumed": ["a test size"], "vocab_size": VOCAB_SIZE, "merges": 0,
           "files": {"writer": "char_writer:write_files", "dir": CONFIG},
           "reference": "char_standin:Reference",
           "initialize": {"is_byte_encoder": False, "prefix": MARK}, "table": "narrow"}
    (pkg / "configs" / f"{CONFIG}.json").write_text(json.dumps(cfg), encoding="utf-8")
    bench = registry.load_benchmark()
    bench["configs"].append({"name": CONFIG, "source": cfg["source"],
                             "file": f"portbench/configs/{CONFIG}.json", "reduced": [],
                             "why": "char mode, a prefix"})
    bench["workloads"].append({"name": CELL, "config": CONFIG, "traffic": "tiny-mix",
                               "chips": 1, "why": "the eager core and the id merge"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(registry, "named", functools.partial(_named, pkg=str(pkg)))
    return root, registry.load_benchmark(str(root))


def found(added) -> tuple[dict, str, dict]:
    """The cell's configuration, its path and its traffic, by their names."""
    root, bench = added
    cell = registry.cell(bench, CELL)
    cfg, path = registry.config(bench, cell["config"], str(root))
    return cfg, path, registry.traffic(cell["traffic"], pkg=str(root / "portbench"))


def test_the_cell_runs_correct_on_the_twins(added, tmp_path, monkeypatch):
    """Blocks of 64 words, so that new words reach the id merge's twin."""
    monkeypatch.setattr(engine_mod, "ROW_BLOCKS", {32: 64, 128: 16})
    cfg, path, traffic = found(added)
    initialize_is_stated(cfg)
    try:
        ob = harness.run_cell(cfg, path, traffic, 2**31 + 21, 0.3, False, device="cpu",
                              cache=str(tmp_path / "cache"))
        engine = ht._get_engine()
        assert engine.ctx.prefix == MARK.encode() and not engine.tables.is_byte_encoder
        assert engine.stat_device_words > 0
    finally:
        ht._reset()
    assert ob.check["correct"], ob.check
    assert ob.check["numbers"]["mismatched_docs"]["value"] == 0
    assert ob.check["numbers"]["docs_compared"]["value"] == 12


def test_the_control_is_not_correct(added, tmp_path):
    cfg, path, traffic = found(added)
    r = control.control_run(cfg, path, traffic, 2**31 + 22, cache=str(tmp_path / "cache"))
    assert not r["correct"] and r["numbers"]["mismatched_docs"]["value"] > 0
    assert r["numbers"]["docs_compared"]["value"] == 12


def test_the_byte_mode_reference_refuses_it(added):
    cfg, path, traffic = found(added)
    cfg = dict(cfg, reference="bpe:Reference")
    files = harness.vocab_files(cfg, path)
    with pytest.raises(ValueError, match="is_byte_encoder=False, prefix='▁'"):
        harness.reference(cfg, files)
    try:  # the run ends in that error where the harness builds the reference
        with pytest.raises(ValueError, match="is_byte_encoder"):
            harness.run_cell(cfg, path, traffic, 5, 0.1, False, device="cpu")
    finally:
        ht._reset()


def test_the_per_configuration_tests_hold_it(added, tmp_path):
    """They pass on the configuration; the oracle's fails on a copy whose
    reference ignores the prefix, and the files' on a copy whose
    vocabulary lacks the prefix's token (it reads no reference)."""
    cfg, path, _traffic = found(added)
    reference_equals_the_ports_oracle(cfg, path, str(tmp_path))
    vocabulary_files_are_as_stated(cfg, path, str(tmp_path))
    with pytest.raises(AssertionError):
        reference_equals_the_ports_oracle(dict(cfg, reference="char_standin:NoPrefix"), path,
                                          str(tmp_path))
    vocab = tmp_path / "root" / "portbench" / "configs" / CONFIG / "vocab.txt"
    lines = vocab.read_text(encoding="utf-8").splitlines(keepends=True)
    mark = "".join(f"0x{b:02X}" for b in MARK.encode()) + " == 256\n"
    vocab.write_text("".join(line for line in lines if line != mark), encoding="utf-8")
    with pytest.raises(AssertionError):
        vocabulary_files_are_as_stated(dict(cfg, vocab_size=VOCAB_SIZE - 1), path, str(tmp_path))
