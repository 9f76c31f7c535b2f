"""A small configuration and traffic for the CPU tests, written under a
test's temporary directory: the configuration's first 2,000 merges and
the ids they use (the narrow table), and 18 documents of the CPython
sample cut to their first 1,500 characters.  And the port's context as
a configuration's options load it."""

from __future__ import annotations

import json
import os

from portbench import registry
from portbench.gen.files import load_sample

MERGES = 2000
SAMPLE = os.path.join(registry.PKG, "data", "cpython-3.12.12-lib.jsonl")
BIG = os.path.join(registry.PKG, "configs", "codeparrot-py-32k")


def tiny_config(tmp_path) -> tuple[dict, str]:
    with open(os.path.join(BIG, "vocab.json"), encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(BIG, "merges.txt"), encoding="utf-8") as f:
        merges = f.read().splitlines()[: MERGES + 1]  # the header, then the rules
    keep = 257 + MERGES  # <|endoftext|>, 256 bytes, one id a merge
    (tmp_path / "tiny").mkdir(exist_ok=True)
    (tmp_path / "tiny" / "vocab.json").write_text(
        json.dumps({t: i for t, i in vocab.items() if i < keep}), encoding="utf-8")
    (tmp_path / "tiny" / "merges.txt").write_text("\n".join(merges) + "\n", encoding="utf-8")
    cfg = {"name": "tiny-2k", "source": "the first 2,000 merges of codeparrot-py-32k",
           "assumed": ["a test size"], "reduced": [],
           "files": {"writer": "hf_bpe:write_files", "dir": "tiny"},
           "reference": "bpe:Reference", "initialize": {"is_byte_encoder": True},
           "table": "narrow"}
    path = tmp_path / "tiny-2k.json"
    path.write_text(json.dumps(cfg))
    return cfg, str(path)


def tiny_traffic(tmp_path, **over) -> dict:
    sample = tmp_path / "tiny-sample.jsonl"
    if not sample.exists():
        docs = load_sample(SAMPLE)[:40:2]
        sample.write_text("".join(json.dumps({"path": str(i), "content": d[:1500]}) + "\n"
                                  for i, d in enumerate(docs[:18])), encoding="utf-8")
    t = {"generator": "files:documents", "sample": str(sample), "docs_per_call": 6,
         "reset_per_pass": True, "warmup_calls": 2, "check_calls": 4, "check_docs": 3}
    t.update(over)
    return t


def port_context(cfg: dict, files: dict):
    """The port's context on the configuration's files, loaded with the
    options the harness hands to ``initialize`` (all but ``token_id``,
    which the facade takes and ignores)."""
    from hutoken_tpu_torch.context import TokenizerContext

    options = {k: v for k, v in cfg["initialize"].items() if k != "token_id"}
    return TokenizerContext.load(files["vocab"], files["special"],
                                 merges_file_path=files["merges"], **options)
