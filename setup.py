"""Build the native host engine into the wheel.

The reference compiles its C extension at install time (reference:
setup.py:27-43); here the C++ host engine (native/src/hutoken_host.cpp)
is built as a plain shared library loaded via ctypes and shipped inside
the package (hutoken_tpu/_native/libhutoken_host.so).  The Extension is
``optional``: if no C++ toolchain is present the wheel installs pure
Python and the engine falls back to the numpy/oracle paths.
"""

import os

from setuptools import Extension, setup
from setuptools.command.build_ext import build_ext


class NativeLibBuild(build_ext):
    """Build a ctypes shared library (not a CPython extension)."""

    def get_ext_filename(self, fullname):
        if fullname.endswith("libhutoken_host"):
            return os.path.join(*fullname.split(".")) + ".so"
        return super().get_ext_filename(fullname)

    def get_export_symbols(self, ext):
        # default implementation insists on PyInit_<name>
        return ext.export_symbols


# wheels default to portable codegen: -march=native baked into a wheel
# SIGILLs on older CPUs (the optional=True escape only covers compile
# failures).  Set HUTOKEN_TPU_MARCH=native for a machine-local build —
# the dev-checkout `make -C native` path already uses it.
_march = os.environ.get("HUTOKEN_TPU_MARCH", "")
_arch_flags = [f"-march={_march}"] if _march else []

# Windows parity (the reference builds there too, taskqueue.h:4-8):
# the engine is std::thread C++17 throughout, so MSVC needs only its
# own flag spelling.  Untested on Windows in this environment; the
# optional=True escape keeps installs working regardless.
if os.name == "nt":  # pragma: no cover - no Windows host here
    _compile_args = ["/O2", "/std:c++17", "/EHsc"]
    _link_args = []
else:
    _compile_args = [
        "-O3", "-std=c++17", "-funroll-loops", "-fPIC", *_arch_flags,
    ]
    _link_args = ["-pthread"]

# one build of the same library for each package: the PyTorch port
# (hutoken_tpu_torch) loads its own copy and imports nothing of hutoken_tpu
native_exts = [
    Extension(
        f"{pkg}._native.libhutoken_host",
        sources=["native/src/hutoken_host.cpp"],
        language="c++",
        extra_compile_args=_compile_args,
        extra_link_args=_link_args,
        optional=True,  # graceful pure-Python fallback
    )
    for pkg in ("hutoken_tpu", "hutoken_tpu_torch")
]

setup(
    ext_modules=native_exts,
    cmdclass={"build_ext": NativeLibBuild},
)
