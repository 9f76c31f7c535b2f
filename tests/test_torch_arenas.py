"""The port's cap on glibc's malloc arenas (``utils/mem.py::cap_arenas``):
after ``initialize``, threads that are alive together share at most
``ARENA_MAX`` arenas, where without the cap each takes one of its own;
and the cap is set once a process.  Each count runs in a fresh
interpreter: an arena, once made, stays, and a pytest worker's own
threads (torch's among them) may already have made several."""

import os
import subprocess
import sys
from types import SimpleNamespace

import pytest

pytest.importorskip("torch")

import fixture_tools as ft  # noqa: E402
from hutoken_tpu_torch import setup_record  # noqa: E402
from hutoken_tpu_torch.utils import mem  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# argv: vocab, special chars, and "cap" to call ``initialize`` first
THREADS = """
import sys, threading
import hutoken_tpu_torch as hutoken
from hutoken_tpu_torch.setup_record import heap_arenas
from hutoken_tpu_torch.utils.mem import tune_allocator

if sys.argv[3] == "cap":
    hutoken.initialize(sys.argv[1], sys.argv[2], is_byte_encoder=True, device="cpu")
else:
    tune_allocator()  # the same thresholds, so the blocks stay on the heap
N = 12
barrier = threading.Barrier(N)

def work():
    blocks = [bytearray(2 << 20) for _ in range(3)]
    barrier.wait(timeout=60)  # alive together
    del blocks

threads = [threading.Thread(target=work) for _ in range(N)]
for t in threads:
    t.start()
for t in threads:
    t.join(timeout=60)
    assert not t.is_alive()
print(heap_arenas())
"""


@pytest.mark.parametrize("cap", [True, False], ids=["initialize", "uncapped"])
def test_threads_alive_together_share_the_capped_arenas(cap):
    if setup_record.heap_arenas() is None:
        pytest.skip("no malloc_info: not glibc")
    vocab_path, special_path = ft.write_byte_level_fixture()
    env = {k: v for k, v in os.environ.items() if k not in ("MALLOC_ARENA_MAX", "GLIBC_TUNABLES")}
    out = subprocess.run(
        [sys.executable, "-c", THREADS, vocab_path, special_path, "cap" if cap else "none"],
        capture_output=True, text=True, timeout=120, cwd=REPO, env=env)
    assert out.returncode == 0, out.stderr
    arenas = int(out.stdout.split()[-1])
    if cap:
        assert 1 <= arenas <= mem.ARENA_MAX == 2
    else:  # the control: glibc's default gives each thread an arena
        assert arenas > mem.ARENA_MAX


def test_the_cap_is_set_once(monkeypatch):
    calls = []

    class LibC:
        def mallopt(self, param, value):
            calls.append((param, value))
            return 1

    monkeypatch.setattr(mem, "ctypes", SimpleNamespace(CDLL=lambda name: LibC()))
    monkeypatch.setattr(mem, "_arenas_done", False)
    mem.cap_arenas()
    mem.cap_arenas()
    assert calls == [(mem.M_ARENA_MAX, mem.ARENA_MAX)] == [(-8, 2)]
