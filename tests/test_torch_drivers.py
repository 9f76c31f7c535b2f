"""The PyTorch port's drivers (``hutoken_tpu_torch.entry``, ``.bench`` and
``.scripts.*``) at small sizes on the CPU (``--device cpu``).

Each run is a subprocess that imports only the port, calls the driver's
``main`` (or ``entry`` / ``dryrun_multichip``), and at its end checks
that neither ``jax`` nor ``hutoken_tpu`` is in ``sys.modules``.  The
drivers check their own outputs (against the oracle, the native engine,
the host trainers or one shard) and raise on a difference, so a run
that exits 0 has passed them; the tests read the lines they print.  Ids
are integers: every comparison is exact.  The JAX side is imported by
the test process only, for the ``convert`` comparison."""

import json
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the engine's blocks cut to 64 / 16 rows, so that small corpora reach
# the device path (the twins on the CPU)
SMALL_BLOCKS = "from hutoken_tpu_torch import engine as E; E.ROW_BLOCKS[32] = 64; E.ROW_BLOCKS[128] = 16"


def _run(body: str, timeout: float = 240) -> str:
    """Run ``body`` in a fresh interpreter that imports only the port;
    returns its standard output."""
    code = textwrap.dedent(body) + textwrap.dedent("""
        import sys as _sys
        _loaded = sorted(m for m in _sys.modules if m.split(".")[0] in ("jax", "jaxlib", "hutoken_tpu"))
        assert not _loaded, _loaded
        print("NO_JAX_LOADED")
    """)
    env = {**os.environ, "PYTHONPATH": REPO, "OMP_NUM_THREADS": "1"}
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=timeout)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert proc.stdout.rstrip().endswith("NO_JAX_LOADED")
    return proc.stdout


def test_entry_and_dryrun_multichip():
    out = _run("""
        import torch
        from hutoken_tpu_torch.entry import dryrun_multichip, entry, tiny_tables
        from hutoken_tpu_torch.ops.fused_merge import fused_merge_plain
        from hutoken_tpu_torch.ops.merge import compact_output

        fn, (raw, lens) = entry(device="cpu")
        assert tuple(raw.shape) == (256, 16) and raw.dtype == torch.uint8
        out = fn(raw, lens)
        _ctx, tab = tiny_tables("cpu")
        want = compact_output(fused_merge_plain(tab, raw, lens)[0], True)
        assert torch.equal(out, want)
        assert int(out[:256].sum()) < int(lens.sum())  # the table merged pairs
        dryrun_multichip(4, device="cpu")
        from hutoken_tpu_torch.entry import main
        main(["--device", "cpu", "--shards", "2"])
    """)
    assert "dryrun_multichip(4, 'cpu'): OK" in out
    assert "dryrun_multichip(2, 'cpu'): OK" in out
    assert "equal to the plain twin" in out


def test_bench_quick_last_line():
    out = _run("""
        from hutoken_tpu_torch.bench import main
        main(["--quick", "--device", "cpu", "--mb", "0.25"])
    """)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    last = lines[-1]
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["unit"] == "MB/s" and last["vs_baseline"] is None and last["value"] > 0
    assert "CPU" in last["metric"]
    full = [x for x in lines if x.get("metric") == last["metric"] and "conformance" in x]
    assert full and full[0]["conformance"] is True
    assert {"device_byte_share", "host_bytes_by_cause", "encode_batch", "median"} <= set(full[0])
    assert lines[0]["device"] == "cpu" and "triton" in lines[0]


def test_bench_kernel_lines():
    """The unique configuration's kernel lines, each checked against the
    oracle inside the driver; on the CPU their times are not measured."""
    out = _run(f"""
        {SMALL_BLOCKS}
        from hutoken_tpu_torch import bench
        bench.KERNEL_WORDS = 512
        rec = bench.run_config("unique", 0.05, True, "cpu", "cpu")
        assert rec["conformance"] is True and rec["device_byte_share"] > 0
    """)
    lines = [json.loads(x) for x in out.splitlines() if x.startswith("{")]
    kernels = [x for x in lines if "kernel" in x["metric"]]
    assert len(kernels) == 2 and all(k["value"] is None and k["ms"] is None for k in kernels)
    assert any("native host engine" in x["metric"] for x in lines)


@pytest.mark.parametrize("mode", ["bbpe", "string"])
def test_benchmark_train(mode):
    out = _run(f"""
        from hutoken_tpu_torch.scripts.benchmark_train import main
        main(["--device", "cpu", "--mb", "0.25", "--merges", "50", "--mode", "{mode}", "--devices", "2"])
    """)
    rec = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
    assert rec["mode"] == mode and rec["shards"] == 2 and rec["merges"] == 50
    assert rec["checked_merges"] == 32 and rec["warmup_s"] is not None


def test_benchmark_sharded():
    out = _run(f"""
        {SMALL_BLOCKS}
        from hutoken_tpu_torch.scripts.benchmark_sharded import main
        main(["--device", "cpu", "--shards", "1,2,4", "--rows", "128", "--iters", "1", "--mb", "0.03"])
    """)
    rec = json.loads([x for x in out.splitlines() if x.startswith("{")][-1])
    assert [r["shards"] for r in rec["runs"]] == [1, 2, 4]
    assert all(len(r["fused_blocks_per_shard"]) == r["shards"] and min(r["fused_blocks_per_shard"]) > 0
               for r in rec["runs"])


def test_profile_merge_and_profile_raw_and_profiler(tmp_path):
    trace = os.path.join(tmp_path, "trace")
    out = _run(f"""
        from hutoken_tpu_torch.scripts import profile_merge, profile_raw, profiler
        profile_merge.main(["--device", "cpu", "--tables", "narrow,char", "--words", "256",
                            "--eager-words", "32", "--eager-blocks", "1", "--mb", "0.5",
                            "--char-words", "64"])
        profile_raw.main(["--device", "cpu", "--mb", "0.2", "--runs", "1"])
        profiler.main(["--device", "cpu", "--mb", "0.05", "--iters", "1", "--trace", {trace!r}])
    """)
    assert out.count("equal to the twin and the oracle") == 3
    assert "eager fixed point narrow block 0: 32 x 128" in out
    assert "id kernel narrow block 0: 32 x 128" in out and "id kernel char block 0: 64 x 32 ids" in out
    assert out.count("equal to the eager twin and the oracle") == 2
    assert "[raw] run 0 host stages" in out and "[pipeline] run 0" in out
    assert os.path.isfile(os.path.join(trace, "trace.json"))
    assert "device time: not measured" in out


def test_convert_equals_the_jax_script(tmp_path):
    vocab = {"a": 0, "b": 1, "ab": 2, "Ġthe": 3, "ő": 4, "<|endoftext|>": 5}
    src = os.path.join(tmp_path, "vocab.json")
    with open(src, "w", encoding="utf-8") as f:
        json.dump(vocab, f)
    ours, theirs = os.path.join(tmp_path, "ours.txt"), os.path.join(tmp_path, "theirs.txt")
    out = _run(f"""
        from hutoken_tpu_torch.scripts.convert import main
        main([{src!r}, {ours!r}])
    """)
    assert f"wrote 6 entries to {ours}" in out
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    try:
        import convert as jax_convert
    finally:
        sys.path.pop(0)
    jax_convert.convert(src, theirs)
    with open(ours, "rb") as a, open(theirs, "rb") as b:
        assert a.read() == b.read()
