"""Build the ``codeparrot-py-32k`` configuration and the ``cpython-lib``
traffic sample from CPython 3.12.12's standard library.

    python3 -m portbench.gen.build_codeparrot_py --lib <prefix>/lib/python3.12

The sample is real Python source, public under the PSF license
(``portbench/data/cpython-LICENSE.txt``).  The library's ``.py`` files
(``site-packages`` and ``__pycache__`` left out; files that are not
UTF-8, hold a NUL or are blank skipped) split in two by the first byte
of the SHA-256 of their path under the library:

* under 128: the traffic sample, ``portbench/data/cpython-3.12.12-lib.jsonl``,
  one ``{"path", "content"}`` line a file in path order, as a code
  dataset's rows hold them;
* the rest: the text the vocabulary is trained on, which is not kept.

The vocabulary follows CodeParrot's published recipe
(``huggingface.co/codeparrot/codeparrot``; its ``bpe_training.py``):
GPT-2's byte-level pre-tokenizer and 256-byte initial alphabet, the
special token ``<|endoftext|>``, a BPE trainer to 32,768 ids.  It is
trained with Hugging Face ``tokenizers``, which the benchmark's runs
never import, and written as ``vocab.json`` and ``merges.txt`` into
``portbench/configs/codeparrot-py-32k/``.  The script is here to show
where the files come from; the runs read only what it wrote.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAMPLE = os.path.join(PKG, "data", "cpython-3.12.12-lib.jsonl")
VOCAB_DIR = os.path.join(PKG, "configs", "codeparrot-py-32k")
VOCAB_SIZE = 32768


def library_files(lib: str) -> dict[str, str]:
    """Path under ``lib`` -> text of every usable ``.py`` file."""
    out = {}
    for d, subdirs, files in os.walk(lib):
        subdirs[:] = sorted(s for s in subdirs if s not in ("site-packages", "__pycache__"))
        for name in sorted(files):
            if not name.endswith(".py"):
                continue
            path = os.path.join(d, name)
            try:
                with open(path, encoding="utf-8") as f:
                    text = f.read()
            except UnicodeDecodeError:
                continue
            if "\x00" not in text and text.strip():
                out[os.path.relpath(path, lib)] = text
    return out


def in_sample(rel: str) -> bool:
    return hashlib.sha256(rel.encode("utf-8")).digest()[0] < 128


def train(texts: list[str], out_dir: str) -> None:
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    trainer = trainers.BpeTrainer(
        vocab_size=VOCAB_SIZE, special_tokens=["<|endoftext|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(), show_progress=False,
    )
    tok.train_from_iterator(texts, trainer)
    os.makedirs(out_dir, exist_ok=True)
    tok.model.save(out_dir)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.gen.build_codeparrot_py")
    ap.add_argument("--lib", required=True, help="CPython 3.12.12's lib/python3.12")
    args = ap.parse_args(argv)
    files = library_files(args.lib)
    sample = {p: t for p, t in files.items() if in_sample(p)}
    os.makedirs(os.path.dirname(SAMPLE), exist_ok=True)
    with open(SAMPLE, "w", encoding="utf-8") as f:
        for path in sorted(sample):
            f.write(json.dumps({"path": "Lib/" + path, "content": sample[path]}) + "\n")
    shutil.copyfile(os.path.join(args.lib, "LICENSE.txt"),
                    os.path.join(PKG, "data", "cpython-LICENSE.txt"))
    train([files[p] for p in sorted(files) if p not in sample], VOCAB_DIR)
    print(f"{len(sample)} files in the sample, {len(files) - len(sample)} trained on")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
