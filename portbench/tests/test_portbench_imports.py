"""Neither JAX nor the JAX package reaches a run, compared by whole
top-level names, and the reference and the generators take nothing of
the program."""

from __future__ import annotations

import ast
import os
import subprocess
import sys

import pytest

from portbench import registry
from portbench.run import forbidden_modules


@pytest.mark.parametrize("names,found", [
    (["hutoken_tpu_torch", "hutoken_tpu_torch.engine", "torch", "numpy"], []),
    (["hutoken_tpu", "hutoken_tpu.engine"], ["hutoken_tpu"]),
    (["jax.numpy", "jax"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["hutoken_tpu_torchx", "jaxtyping", "flaxen"], []),
])
def test_top_level_names_compare_whole(names, found):
    assert forbidden_modules(names) == found


def imported_roots(path: str) -> set[str]:
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            roots.add(node.module.split(".")[0])
    return roots


def sources(sub: str = ""):
    base = os.path.join(registry.PKG, sub)
    for d, _dirs, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_file_of_the_harness_imports_jax():
    for path in sources():
        if os.sep + "tests" + os.sep in path:
            continue
        assert not imported_roots(path) & {"jax", "jaxlib", "flax", "hutoken_tpu"}, path


@pytest.mark.parametrize("sub", ["reference", "gen"])
def test_reference_and_generators_take_nothing_of_the_program(sub):
    for path in sources(sub):
        assert not imported_roots(path) & {"torch", "hutoken_tpu_torch", "hutoken_tpu", "jax"}, path


def test_a_process_that_runs_the_harness_loads_no_jax():
    code = (
        "import sys\n"
        "import portbench.run, portbench.harness, portbench.control\n"
        "import hutoken_tpu_torch, hutoken_tpu_torch.engine\n"
        "from portbench.run import forbidden_modules\n"
        "print(forbidden_modules(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith("HUTOKEN_TPU_")}
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
