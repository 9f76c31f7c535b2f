"""DEBUG-env-gated timestamped stderr logging.

The port's own copy of ``hutoken_tpu/utils/logging.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Capability parity with the reference's logger (reference: src/helper.c:23-49):
the ``DEBUG`` environment variable is read once, at first use, and when it is
exactly ``"1"`` every ``log_debug`` call prints a ``[YYYY-mm-dd HH:MM:SS]
DEBUG: ...`` line to stderr.
"""

from __future__ import annotations

import os
import sys
import time

_debug_enabled: bool | None = None


def initialize_logging() -> None:
    """Read the DEBUG env var once (reference: src/helper.c:23-29)."""
    global _debug_enabled
    _debug_enabled = os.environ.get("DEBUG") == "1"


def debug_enabled() -> bool:
    if _debug_enabled is None:
        initialize_logging()
    return bool(_debug_enabled)


def log_debug(fmt: str, *args: object) -> None:
    """Timestamped stderr debug line (reference: src/helper.c:31-49)."""
    if not debug_enabled():
        return
    ts = time.strftime("%Y-%m-%d %H:%M:%S")
    msg = (fmt % args) if args else fmt
    print(f"[{ts}] DEBUG: {msg}", file=sys.stderr)
