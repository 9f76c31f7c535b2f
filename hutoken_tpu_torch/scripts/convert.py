"""Convert a Hugging Face ``vocab.json`` into the hutoken hex vocab format
(counterpart of ``scripts/convert.py``), through the port's
``hf_import``: one ``0xAA0xBB.. == id`` line per token, in id order.

    python -m hutoken_tpu_torch.scripts.convert vocab.json vocab.txt

It runs on the host only: there is no device work, so it takes no
``--device``.
"""

from __future__ import annotations

import argparse
import json
import sys

from ..hf_import import _write_hex_vocab


def convert(src: str, dst: str) -> int:
    """Write ``src``'s vocabulary to ``dst``; returns its entry count."""
    with open(src, encoding="utf-8") as f:
        vocab = json.load(f)
    _write_hex_vocab(dst, vocab)
    return len(vocab)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="the Hugging Face vocab.json")
    ap.add_argument("dst", help="the hex vocab file to write")
    args = ap.parse_args(argv)
    print(f"wrote {convert(args.src, args.dst)} entries to {args.dst}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
