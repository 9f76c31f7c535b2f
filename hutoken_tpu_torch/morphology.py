"""Hungarian morphological analysis via the foma/emMorph FST.

The port's own copy of ``hutoken_tpu/morphology.py``, so that the
port imports nothing of the JAX package; ``tests/test_torch_host.py``
holds the two equal.

Feature parity with the reference's optional USE_FOMA subsystem
(reference: src/core.c:583-698, src/lib.c:1096-1126, setup.py:5-25).  The
FST apply machinery is inherently host-side (libfoma is an external C
library); we bind it with ctypes when present, exactly as the reference
compile-gates on probing for ``fomalib.h``.

``initialize_foma()`` loads ``./bin/hu.foma.bin`` and returns an opaque
handle; ``look_up_word(handle, word, only_longest)`` runs ``apply_up``
repeatedly, splits each analysis on ``[tag]`` boundaries keeping the
morpheme substrings (odd strtok positions, src/core.c:644-659), and in
``only_longest`` mode keeps the analysis with the strictly-largest
morpheme count seen so far (src/core.c:621-629).
"""

from __future__ import annotations

import ctypes
import ctypes.util
from typing import Optional

_lib: Optional[ctypes.CDLL] = None
_probed = False


def _load_lib() -> Optional[ctypes.CDLL]:
    global _lib, _probed
    if _probed:
        return _lib
    _probed = True
    path = ctypes.util.find_library("foma")
    if path is None:
        return None
    try:
        lib = ctypes.CDLL(path)
        lib.fsm_read_binary_file.restype = ctypes.c_void_p
        lib.fsm_read_binary_file.argtypes = [ctypes.c_char_p]
        lib.apply_init.restype = ctypes.c_void_p
        lib.apply_init.argtypes = [ctypes.c_void_p]
        lib.apply_up.restype = ctypes.c_char_p
        lib.apply_up.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        _lib = lib
    except (OSError, AttributeError):
        _lib = None
    return _lib


def available() -> bool:
    """Mirrors the reference's compile-time USE_FOMA autodetection
    (setup.py:5-25) as a runtime probe."""
    return _load_lib() is not None


def initialize_foma(fst_path: str = "./bin/hu.foma.bin"):
    """Load the FST and return an apply handle (src/core.c:585-606)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("Foma support is not installed.")
    net = lib.fsm_read_binary_file(fst_path.encode())
    if not net:
        raise FileNotFoundError("Failed to read the finite state machine")
    handle = lib.apply_init(ctypes.c_void_p(net))
    if not handle:
        raise ValueError("Couldn't initialize apply_handle.")
    return ctypes.c_void_p(handle)


def split_analysis(analysis: str) -> list[str]:
    """Split ``morpheme[Tag]morpheme[Tag]...`` keeping morphemes.

    Reproduces strtok(tmp, "[]") keeping odd-position non-empty pieces
    (src/core.c:644-659): strtok collapses delimiter runs, so pieces
    alternate morpheme/tag starting with a morpheme.
    """
    pieces = []
    cur = []
    for ch in analysis:
        if ch in "[]":
            if cur:
                pieces.append("".join(cur))
                cur = []
        else:
            cur.append(ch)
    if cur:
        pieces.append("".join(cur))
    return [p for i, p in enumerate(pieces) if i % 2 == 0 and p]


def look_up_word(handle, word: str, only_longest: bool = False) -> list[list[str]]:
    """Collect analyses via repeated apply_up (src/core.c:608-696)."""
    lib = _load_lib()
    if lib is None:
        raise RuntimeError("Foma support is not installed.")
    results: list[list[str]] = []
    max_morpheme_count = 0
    arg: Optional[bytes] = word.encode("utf-8")
    while True:
        raw = lib.apply_up(handle, arg)
        if raw is None:
            break
        analysis = raw.decode("utf-8")
        if only_longest:
            morpheme_count = analysis.count("[")
            if morpheme_count > max_morpheme_count:
                max_morpheme_count = morpheme_count
            else:
                arg = None
                continue
        morphemes = split_analysis(analysis)
        if only_longest:
            if not results:
                results.append(morphemes)
            else:
                results[0] = morphemes
        else:
            results.append(morphemes)
        arg = None
    return results
