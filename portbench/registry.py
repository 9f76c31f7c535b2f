"""Find each piece of the benchmark by the name ``BENCHMARK.json`` gives it.

* a cell is an entry of ``workloads``;
* its configuration is ``configs/<config>.json`` (the entry's ``file``),
  which names the writer of its vocabulary files (``files.writer``, a
  ``module:function`` of ``gen/``), its plain reference
  (``reference``, a ``module:Class`` of ``reference/``) and the options
  that ``initialize`` and the reference both take (``initialize``);
* its traffic mix is ``traffic/<traffic>.json``, which names its
  generator (``generator``, a ``module:function`` of ``gen/``);
* every metric is read by ``metrics/<metric>.py``, whose ``read(obs)``
  returns the value or None: an end-to-end one from the untraced run's
  window (``harness.Observations.end_to_end``), a per-layer one from the
  traced run's readings (``harness.observe``).  A kernel's reader also
  names the entry it wraps and how it counts a launch's work
  (``trace.Tracer``).

A later change adds a file and an entry; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os

PKG = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(PKG)


class BenchError(RuntimeError):
    """A run that cannot be made as the benchmark states it."""


def load_benchmark(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.isfile(path):
        raise BenchError(f"no BENCHMARK.json at {root}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise BenchError(f"no workload named {name!r} in BENCHMARK.json")


def config(bench: dict, name: str, root: str = ROOT) -> tuple[dict, str]:
    """(configuration, path of its file)."""
    for c in bench["configs"]:
        if c["name"] == name:
            path = os.path.join(root, c["file"])
            with open(path, encoding="utf-8") as f:
                return json.load(f), path
    raise BenchError(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, pkg: str = PKG) -> dict:
    path = os.path.join(pkg, "traffic", f"{name}.json")
    if not os.path.isfile(path):
        raise BenchError(f"no traffic file {path}")
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def named(spec: str, package: str, pkg: str = PKG):
    """The object ``module:attr`` names in ``portbench/<package>/``."""
    module, _, attr = spec.partition(":")
    path = os.path.join(pkg, package, f"{module}.py")
    if not attr or not os.path.isfile(path):
        raise BenchError(f"{spec!r} names nothing in {os.path.join(pkg, package)}")
    return getattr(_load(f"portbench.{package}.{module}", path), attr)


def _load(qualname: str, path: str):
    spec = importlib.util.spec_from_file_location(qualname, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def reader_module(name: str, pkg: str = PKG):
    """``metrics/<name>.py``."""
    path = os.path.join(pkg, "metrics", f"{name}.py")
    if not os.path.isfile(path):
        raise BenchError(f"no reader {path} for the metric {name!r}")
    return _load(f"portbench.metrics.{name}", path)


def reader(name: str, pkg: str = PKG):
    """The ``read`` function of ``metrics/<name>.py``."""
    return reader_module(name, pkg).read


def kernel_readers(bench: dict, cell_name: str) -> list:
    """The readers of the cell's per-layer metrics that wrap a kernel's
    entry (``ENTRY``)."""
    mods = [reader_module(m["name"]) for m in metrics_of(bench, cell_name, True)]
    return [m for m in mods if hasattr(m, "ENTRY")]


def metrics_of(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: the end-to-end ones, or
    with ``trace`` the per-layer ones, each where its ``workloads`` (if
    any) list the cell."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell_name in m["workloads"]]
