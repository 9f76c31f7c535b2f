"""The writer of a tiny char-mode configuration's files, for the
harness's tests, copied into ``gen/`` of a copy of the harness: the
files hutoken loads (``vocab.txt``, ``special_chars.txt``) lie as they
are in the directory beside the configuration file, and there is no
merges file, so a pair's rank is the id of its join."""

from __future__ import annotations

import os


def write_files(config: dict, config_path: str, cache: str | None = None) -> dict:
    """Paths of the files hutoken loads; ``merges`` is None."""
    base = os.path.join(os.path.dirname(os.path.abspath(config_path)), config["files"]["dir"])
    return {"vocab": os.path.join(base, "vocab.txt"),
            "special": os.path.join(base, "special_chars.txt"), "merges": None}
