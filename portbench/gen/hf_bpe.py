"""A byte-level BPE vocabulary in Hugging Face's files, written out as
hutoken loads it.

A configuration's ``files`` block names this writer
(``"writer": "hf_bpe:write_files"``), the directory beside the
configuration file that holds ``vocab.json`` (spelling -> id) and
``merges.txt`` as a tokenizer's ``save_pretrained`` leaves them, and
nothing else.  The writer turns them into what hutoken's Hugging Face
import (``hutoken_tpu_torch/hf_import.py``) writes for such a tokenizer:

* ``vocab.txt``: one ``0xNN0xNN.. == id`` line per token in id order,
  the UTF-8 bytes of its spelling in hex;
* ``special_chars.txt``: GPT-2's byte map for the bytes it remaps;
* ``merges.txt``: the rules as they are.

The files are cached under ``portbench/.cache/<config>-<digest>/``,
keyed by a digest of this writer, the configuration file and the files
it names, so only the first run in a checkout writes them.  Imports
neither ``torch`` nor anything of the port.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
CACHE = os.path.join(os.path.dirname(HERE), ".cache")

# bytes that GPT-2's byte encoder remaps to codepoints >= 256
SPECIAL_CHAR_BYTES = list(range(33)) + [127] + list(range(128, 161)) + [173]


def gpt2_bytes_to_unicode() -> dict[int, str]:
    """GPT-2's public byte -> character map."""
    bs = (
        list(range(ord("!"), ord("~") + 1))
        + list(range(0xA1, 0xAC + 1))
        + list(range(0xAE, 0xFF + 1))
    )
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


def source_files(config: dict, config_path: str) -> dict[str, str]:
    """Paths of the configuration's ``vocab.json`` and ``merges.txt``."""
    base = os.path.join(os.path.dirname(os.path.abspath(config_path)), config["files"]["dir"])
    return {"vocab_json": os.path.join(base, "vocab.json"),
            "merges_txt": os.path.join(base, "merges.txt")}


def convert(src: dict[str, str], directory: str) -> None:
    """Write ``vocab.txt``, ``special_chars.txt`` and ``merges.txt``."""
    with open(src["vocab_json"], encoding="utf-8") as f:
        vocab = json.load(f)
    with open(os.path.join(directory, "vocab.txt"), "w", encoding="utf-8") as f:
        for spelling, idx in sorted(vocab.items(), key=lambda kv: kv[1]):
            f.write("".join(f"0x{b:02X}" for b in spelling.encode("utf-8")) + f" == {idx}\n")
    b2u = gpt2_bytes_to_unicode()
    with open(os.path.join(directory, "special_chars.txt"), "w", encoding="utf-8") as f:
        for b in SPECIAL_CHAR_BYTES:
            f.write(f"{b} == {b2u[b]}\n")
    shutil.copyfile(src["merges_txt"], os.path.join(directory, "merges.txt"))


def digest(paths) -> str:
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(f.read() + b"\0")
    return h.hexdigest()[:16]


def write_files(config: dict, config_path: str, cache: str | None = None) -> dict:
    """Paths of the files hutoken loads (``vocab``, ``special``,
    ``merges``), written into ``cache`` (default ``CACHE``) on first
    use."""
    cache = cache or CACHE
    src = source_files(config, config_path)
    key = digest([os.path.abspath(__file__), config_path, *src.values()])
    directory = os.path.join(cache, f"{config['name']}-{key}")
    if not os.path.isdir(directory):
        os.makedirs(cache, exist_ok=True)
        tmp = tempfile.mkdtemp(prefix=".tmp-", dir=cache)
        try:
            convert(src, tmp)
            os.replace(tmp, directory)  # atomic: concurrent runs agree
        except OSError:
            if not os.path.isdir(directory):
                raise
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
    return {name: os.path.join(directory, f"{stem}.txt")
            for name, stem in (("vocab", "vocab"), ("special", "special_chars"),
                               ("merges", "merges"))}
