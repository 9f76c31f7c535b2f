"""Build the hand-written CUDA kernels of ``csrc/`` at first use.

Each kernel is one ``.cu`` file with a plain C interface, compiled by
``nvcc`` for ``sm_90a`` into a shared library under ``_build/`` and
bound with ``ctypes`` by its wrapper module.  A library's file name
carries a digest of its source, of every header the source includes
with quotes, and of the flags, so an edited header never loads a stale
library.
"""

from __future__ import annotations

import hashlib
import os
import re
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.MULTILINE)


def nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def local_includes(path: str) -> list[str]:
    """File names of the ``#include "..."`` lines of a source."""
    with open(path, "rb") as f:
        return [m.decode() for m in _LOCAL_INCLUDE.findall(f.read())]


def kernel_files(source: str) -> list[str]:
    """A ``.cu`` file and every header it includes with quotes, directly
    or through another header (found beside the including file)."""
    files = [source]
    for f in files:  # grows while it is walked
        for name in local_includes(f):
            path = os.path.join(os.path.dirname(f), name)
            if path not in files:
                files.append(path)
    return files


def source_digest(paths, flags=NVCC_FLAGS) -> str:
    """Digest over each file's name and bytes, then the flags."""
    h = hashlib.sha256()
    for p in paths:
        with open(p, "rb") as f:
            h.update(os.path.basename(p).encode() + b"\0" + f.read() + b"\0")
    h.update(" ".join(flags).encode())
    return h.hexdigest()[:16]


def build_library(name: str) -> str:
    """Compile ``csrc/<name>.cu`` into ``_build/lib<name>_<digest>.so``
    unless it exists; returns its path."""
    source = os.path.join(CSRC, f"{name}.cu")
    so = os.path.join(BUILD_DIR, f"lib{name}_{source_digest(kernel_files(source))}.so")
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [nvcc(), *NVCC_FLAGS, "-o", tmp, source],
            capture_output=True, text=True, timeout=600,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name} ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so)  # atomic: concurrent builds agree on one file
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return so
