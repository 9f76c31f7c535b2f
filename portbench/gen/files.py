"""Traffic from a sample of real documents.

A traffic file that names this generator (``"generator":
"files:documents"``) names a JSON-lines sample under ``portbench/``
(``"sample"``), one document a line as ``{"path": ..., "content":
...}``.  Every seed takes the whole sample, so every pass holds the same
documents and bytes; the seed only orders them.
"""

from __future__ import annotations

import json
import os
import random

PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_sample(path: str) -> list[str]:
    """The documents of a sample, in the file's order."""
    with open(path, encoding="utf-8") as f:
        return [json.loads(line)["content"] for line in f if line.strip()]


def documents(traffic: dict, seed: int) -> list[str]:
    """The sample's documents in an order drawn from ``seed``."""
    docs = load_sample(os.path.join(PKG, traffic["sample"]))
    random.Random(seed).shuffle(docs)
    return docs
