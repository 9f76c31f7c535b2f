"""Build the ``deepseek-v3-128k-py`` configuration's vocabulary from the
Python files of an installed ``site-packages``.

    python3 -m portbench.gen.build_deepseek_v3_py --site <prefix>/lib/python3.12/site-packages

DeepSeek-V3's tokenizer is a byte-level BPE of 128K ids (DeepSeek-V3
technical report, arXiv 2412.19437, section 4.1).  Its files are not
part of this repository, and CPython's library is too small to train it: the
half that ``build_codeparrot_py.py`` trains on stops at 41,828 ids, every
word fully merged.  So the recipe runs on a larger public sample of
Python code, the packages installed beside the interpreter.

The corpus: every ``.py`` file under ``--site`` (``__pycache__`` left
out) whose path under it has a SHA-256 whose first byte is under
``CUT``; a file that is not UTF-8, holds a NUL, is blank, passes
``MAX_FILE_BYTES`` or equals a document of the traffic sample is
skipped.  Files are taken in path order.  The corpus is not kept: the
configuration's ``train_corpus`` records its file count, its bytes, a
SHA-256 over each file's path and text, and under ``packages`` the
installed distributions (``name==version``) its files belong to, with
the count of each.  So the corpus can be named and installed again
elsewhere, and another machine can tell whether it holds the same one.

This is a byte-level BPE on Python at DeepSeek-V3's width, not
DeepSeek-V3's merges.

The vocabulary: GPT-2's byte-level pre-tokenizer and 256-byte initial
alphabet, DeepSeek-V3's two special tokens, a BPE trainer to 128,000
ids, trained with Hugging Face ``tokenizers`` (which the benchmark's
runs never import) and written as ``vocab.json`` and ``merges.txt``
into ``portbench/configs/deepseek-v3-128k-py/``.  The script is here to
show where the files come from; the runs read only what it wrote.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
from collections import Counter

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = "deepseek-v3-128k-py"
CONFIG = os.path.join(PKG, "configs", f"{NAME}.json")
VOCAB_DIR = os.path.join(PKG, "configs", NAME)
SAMPLE = os.path.join(PKG, "data", "cpython-3.12.12-lib.jsonl")
VOCAB_SIZE = 128000
SPECIAL_TOKENS = ["<｜begin▁of▁sentence｜>", "<｜end▁of▁sentence｜>"]
CUT = 40  # of 256: about a sixth of the files
MAX_FILE_BYTES = 1_000_000


def in_corpus(rel: str) -> bool:
    return hashlib.sha256(rel.encode("utf-8")).digest()[0] < CUT


def corpus_files(site: str, sample: str = SAMPLE) -> dict[str, str]:
    """Path under ``site`` -> text of every file of the corpus, in path
    order."""
    with open(sample, encoding="utf-8") as f:
        held_out = {json.loads(line)["content"] for line in f if line.strip()}
    out = {}
    for d, subdirs, files in os.walk(site):
        subdirs[:] = sorted(s for s in subdirs if s != "__pycache__")
        for name in sorted(files):
            path = os.path.join(d, name)
            rel = os.path.relpath(path, site)
            if not name.endswith(".py") or not in_corpus(rel) or not os.path.isfile(path):
                continue
            if os.path.getsize(path) > MAX_FILE_BYTES:
                continue
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            except UnicodeDecodeError:
                continue
            if "\x00" not in text and text.strip() and text not in held_out:
                out[rel] = text
    return dict(sorted(out.items()))


def corpus_record(files: dict[str, str]) -> dict:
    """File count, UTF-8 bytes and SHA-256 of the corpus."""
    h = hashlib.sha256()
    nbytes = 0
    for rel, text in files.items():
        data = text.encode("utf-8")
        nbytes += len(data)
        h.update(rel.encode("utf-8") + b"\0" + data + b"\0")
    return {"files": len(files), "bytes": nbytes, "sha256": h.hexdigest()}


def corpus_packages(site: str, rels) -> dict[str, int]:
    """``name==version`` of each distribution installed under ``site``
    -> how many of the files ``rels`` its RECORD lists; a file that no
    RECORD lists counts under ``unrecorded``."""
    from importlib import metadata

    owner = {}
    for dist in metadata.distributions(path=[site]):
        name = f"{dist.metadata['Name']}=={dist.version}"
        for f in dist.files or ():
            owner[str(f)] = name
    return dict(sorted(Counter(owner.get(rel, "unrecorded") for rel in rels).items()))


def train(texts: list[str], out_dir: str) -> None:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=VOCAB_SIZE, special_tokens=SPECIAL_TOKENS,
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
    )
    tok.train_from_iterator(texts, trainer)
    os.makedirs(out_dir, exist_ok=True)
    tok.model.save(out_dir)


def write_record(record: dict, config: str = CONFIG) -> None:
    """Put ``record`` into the configuration's ``train_corpus``."""
    with open(config, encoding="utf-8") as f:
        cfg = json.load(f)
    cfg["train_corpus"].update(record)
    with open(config, "w", encoding="utf-8") as f:
        f.write(json.dumps(cfg, indent=2, ensure_ascii=False) + "\n")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.gen.build_deepseek_v3_py")
    ap.add_argument("--site", required=True, help="a site-packages directory")
    args = ap.parse_args(argv)
    files = corpus_files(args.site)
    record = corpus_record(files)
    record["packages"] = corpus_packages(args.site, files)
    train(list(files.values()), VOCAB_DIR)
    write_record(record)
    print(json.dumps({k: record[k] for k in ("files", "bytes", "sha256")}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
