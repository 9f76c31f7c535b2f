"""The port's multi-process runtime (``hutoken_tpu_torch/parallel/
multihost.py``) and the trainers and collectives across processes, in
subprocesses over ``torch.distributed``'s gloo backend on CPU shards:
the counterpart of ``tests/test_multihost.py``.  The children import
only the port (and check that neither ``jax`` nor ``hutoken_tpu`` was
loaded); a process group is process-global, so none is made here."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


_PRELUDE = r"""
import os
import sys

sys.path.insert(0, {repo!r})
import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)
from hutoken_tpu_torch.parallel import data_mesh, shard_batch
from hutoken_tpu_torch.parallel import collectives as C
from hutoken_tpu_torch.parallel import train as PT
from hutoken_tpu_torch.parallel.multihost import global_data_mesh, initialize_distributed
from hutoken_tpu_torch.train.bbpe import bbpe_train_core
from hutoken_tpu_torch.train.bpe import bpe_train_core


def no_jax():
    loaded = [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hutoken_tpu")]
    assert not loaded, loaded[:5]
"""

_CHILD1 = _PRELUDE + r"""
initialize_distributed({addr!r}, 1, 0, backend="gloo")
initialize_distributed({addr!r}, 1, 0, backend="gloo")  # a second call is a no-op
assert dist.is_initialized() and dist.get_world_size() == 1
mesh = global_data_mesh(4, device="cpu")
assert mesh.size == 4 and mesh.process_count == 1, mesh
corpus = b"ababab the cat sat on the mat " * 20
got = PT.distributed_bbpe_train(corpus, 270, mesh=mesh, verbose=False)
assert got == bbpe_train_core(corpus, 270, verbose=False)
dist.destroy_process_group()
no_jax()
print("MULTIHOST-OK")
"""

_CHILD2 = r"""
pid = {pid}
initialize_distributed({addr!r}, 2, pid, backend="gloo")
mesh = global_data_mesh(4, device="cpu")
assert (mesh.size, mesh.process_index, mesh.process_count) == (8, pid, 2), mesh
assert list(C.axis_index(mesh)) == list(range(4 * pid, 4 * pid + 4))
one = data_mesh(8, device="cpu")  # the same 8 shards in one process
"""

_TRAIN = _PRELUDE + _CHILD2 + r"""
corpus = b"ababab the cat sat on the mat dog nap " * 16
got = PT.distributed_bbpe_train(corpus, 270, mesh=mesh, verbose=False)
gots = PT.distributed_bpe_train(corpus, 268, mesh=mesh, verbose=False)
os.environ["HUTOKEN_TPU_TRAIN_FORCE_CANDIDATES"] = "1"
gotc = PT.distributed_bbpe_train(corpus, 270, mesh=mesh, verbose=False)
dist.destroy_process_group()
want = bbpe_train_core(corpus, 270, verbose=False)
assert got == want and gotc == want, "bbpe parity"
assert gots == bpe_train_core(corpus, 268, strict=False, verbose=False), "string parity"
no_jax()
print("MULTIHOST2-OK" if pid == 0 else "WORKER-OK")
"""

_COLLECTIVES = _PRELUDE + _CHILD2 + r"""
rng = np.random.default_rng(5)
for dtype in (torch.int32, torch.int64, torch.bool):
    full = torch.from_numpy(rng.integers(-3, 50, (8, 6))).to(dtype)
    mine = [full[s] for s in C.axis_index(mesh)]
    every = list(full)
    assert torch.equal(C.all_gather(mine, mesh), C.all_gather(every))
    if dtype != torch.bool:
        for f in (C.psum, C.pmax):
            got, want = f(mine, mesh), f(every)
            assert got.dtype == want.dtype and torch.equal(got, want), (f, dtype)
            got0, want0 = f([x[0] for x in mine], mesh), f([x[0] for x in every])
            assert got0.shape == () and torch.equal(got0, want0)
# ragged: lengths 0-5, shard 2 and a whole process's shards empty in turn
for lens in ([3, 0, 5, 1, 2, 4, 0, 1], [0, 0, 0, 0, 2, 1, 0, 3]):
    parts = [torch.arange(n, dtype=torch.int64) + 10 * s for s, n in enumerate(lens)]
    got = C.all_gather_ragged([parts[s] for s in C.axis_index(mesh)], mesh)
    assert torch.equal(got, torch.cat(parts))
# the trainers' shard ops on the same 8 shards
data = np.frombuffer(b"ababab the cat sat on the mat dog nap " * 9, np.uint8).astype(np.int32)
ids, ids1 = shard_batch(mesh, data), shard_batch(one, data)
assert all(torch.equal(a, ids1[s]) for a, s in zip(ids, C.axis_index(mesh)))
assert np.array_equal(PT._fetch_global(ids, mesh), PT._fetch_global(ids1, one))
ops, ops1 = PT._make_shard_ops(300, mesh, k_top=4), PT._make_shard_ops(300, one, k_top=4)


def same(a, b):
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


def local(shards):
    return [shards[s] for s in C.axis_index(mesh)]


cand = ops["count_candidates"](ids)
assert same(cand, ops1["count_candidates"](ids1))
h, o = ops["count_shard"](ids)
h1, o1 = ops1["count_shard"](ids1)
assert same(PT.psum(h, mesh), PT.psum(h1)) and same(PT.pmax(o, mesh), PT.pmax(o1))
id1, id2, _c, _ok = ops["pick_candidates"](*cand)
assert same(ops["apply_merge"](ids, id1, id2, 256), local(ops1["apply_merge"](ids1, id1, id2, 256)))
c1 = torch.tensor([97, 32, -1], dtype=torch.int32)
c2 = torch.tensor([98, 116, -1], dtype=torch.int32)
assert same(ops["apply_merge_multi"](ids, c1, c2, 257), local(ops1["apply_merge_multi"](ids1, c1, c2, 257)))
assert same(ops["probe_pairs"](ids, c1, c2), ops1["probe_pairs"](ids1, c1, c2))
gh = torch.arange(256, dtype=torch.int64) * 7 + 1
gp = torch.full((256,), 1000003, dtype=torch.int64)
assert same(ops["group_pick"](ids, gh, gp), ops1["group_pick"](ids1, gh, gp))
# shards emptied of pairs: the ragged gather of group_pick, a process empty
hole = np.full(data.shape[0], -1, np.int32)
hole[-30:] = data[:30]
assert same(ops["group_pick"](shard_batch(mesh, hole), gh, gp),
            ops1["group_pick"](shard_batch(one, hole), gh, gp))
assert ops["group_pick"](shard_batch(mesh, np.full(64, -1, np.int32)), gh, gp) is None
dist.destroy_process_group()
no_jax()
print("COLLECTIVES-OK" if pid == 0 else "WORKER-OK")
"""

_EDGES = _PRELUDE + _CHILD2 + r"""
ABAB = (b"abab" * 200) + (b"aab" * 100)
want = bpe_train_core(ABAB, 300, strict=False, verbose=False)
# the spelling hash cut to its first byte: the device exact pick's
# groups collide and the host pick runs on the stream gathered from
# both processes; then the per-merge loop with its self-check
PT.SPELL_HASH_P = np.uint64(0)
orig = PT._make_shard_ops
PT._make_shard_ops = lambda K, m, k_top=1024: orig(K, m, k_top=k_top if k_top == PT.DEEP_K else 2)
assert PT.distributed_bpe_train(ABAB, 300, mesh=mesh, verbose=False) == want
os.environ["HUTOKEN_TPU_STRING_SCAN"] = "0"
os.environ["HUTOKEN_TPU_TRAIN_SELFCHECK"] = "1"
assert PT.distributed_bpe_train(ABAB, 300, mesh=mesh, verbose=False) == want
# a winner with more compositions than MAXC needs the host merge, which
# refuses more than one process, on both at the same merge
PT.MAXC = 1
try:
    PT.distributed_bpe_train(ABAB, 300, mesh=mesh, verbose=False)
except NotImplementedError as e:
    assert "single-process" in str(e)
    refused = True
else:
    refused = False
assert refused, "host_merge ran across processes"
dist.destroy_process_group()
no_jax()
print("EDGES-OK" if pid == 0 else "WORKER-OK")
"""


def _env():
    # the children pin nothing of JAX's platform: they never import it
    return {k: v for k, v in os.environ.items() if k not in ("PYTHONPATH",)}


def test_one_process_world_initialized_twice_trains():
    """A 1-process gloo world: the wrapper joins it (twice, the second a
    no-op), the global mesh spans 4 CPU shards, and the trainer on it
    equals the host core (subprocess: the process group is
    process-global and must not leak into other tests)."""
    code = _CHILD1.format(repo=REPO, addr=f"localhost:{_free_port()}")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=240, env=_env())
    assert "MULTIHOST-OK" in proc.stdout, (proc.stdout, proc.stderr[-2000:])


def _two_processes(script: str, ok: str):
    addr = f"localhost:{_free_port()}"
    procs = [
        subprocess.Popen([sys.executable, "-c", script.format(repo=REPO, addr=addr, pid=pid)],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=_env())
        for pid in (0, 1)
    ]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=420)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    assert outs[0][0] == 0 and ok in outs[0][1], (outs[0][1], outs[0][2][-2000:])
    assert outs[1][0] == 0 and "WORKER-OK" in outs[1][1], (outs[1][1], outs[1][2][-2000:])


@pytest.mark.parametrize(
    "script,ok",
    [(_TRAIN, "MULTIHOST2-OK"), (_COLLECTIVES, "COLLECTIVES-OK"), (_EDGES, "EDGES-OK")],
    ids=["trainers", "collectives", "edges"],
)
def test_two_processes(script, ok):
    """Two processes of 4 CPU shards each, one 8-shard global mesh over
    gloo: the bbpe trainer (dense and candidate picks) and the string
    trainer equal the host cores; every collective and shard op equals
    the 1-process result on the same 8 shards; the host pick's stream
    is gathered across processes; a winner past ``MAXC`` is refused."""
    _two_processes(script, ok)
