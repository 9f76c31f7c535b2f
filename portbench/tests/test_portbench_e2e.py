"""One run of the harness end to end on the CPU, at a tiny size, with
the program's plain twins (``device="cpu"``): it is a rehearsal, and no
number it reads is reported under a card metric's name.  Then the same
run with the timed path broken underneath, once per fault the cell can
have (a token altered in the fused kernel, half of the batch left out,
an answer left unchanged, a call that raises), and the control in the
program's place: each has to come out as not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from portbench import control, harness, registry
from tiny import tiny_config, tiny_traffic

torch = pytest.importorskip("torch")
import hutoken_tpu_torch as ht  # noqa: E402
import hutoken_tpu_torch.engine as engine_mod  # noqa: E402

CELL = "codeparrot-cpython-shard"


@pytest.fixture
def small_blocks(monkeypatch):
    """Blocks of 64 words, so that a tiny call's new words reach the
    fused kernel's twin instead of the host tail."""
    monkeypatch.setattr(engine_mod, "ROW_BLOCKS", {32: 64, 128: 16})


def run(tmp_path, trace=False, seconds=0.3, seed=2**31 + 11):
    cfg, path = tiny_config(tmp_path)
    kernels = registry.kernel_readers(registry.load_benchmark(), CELL)
    return harness.run_cell(cfg, path, tiny_traffic(tmp_path), seed, seconds, trace,
                            device="cpu", cache=str(tmp_path / "cache"), kernels=kernels)


def test_a_traced_run_on_the_twins_is_correct(tmp_path, small_blocks):
    ob = run(tmp_path, trace=True)
    assert ob.check["correct"], ob.check
    assert ob.check["numbers"]["docs_compared"]["value"] == 12
    assert ob.window.calls >= 4 and ob.failed_calls == 0 and ob.setup_s > 0
    obs = ob.obs
    assert obs["kernels"]["fused_merge"]["launches"] > 0  # the twin, counted by the wrapper
    assert obs["launches"] == {"fused_merge": 0}  # the program counts card launches only
    assert obs["kernels"]["fused_merge"]["out_ids"] > 0
    assert obs["device"] is None and obs["core_s"] > 0
    bench = registry.load_benchmark()
    got = {m["name"]: registry.reader(m["name"])(obs) for m in bench["per_layer"]}
    assert got["facade.ms_per_MB"] > 0 and got["engine.ms_per_MB"] > 0
    assert got["device.idle_share"] is None and got["fused_merge_roofline"] is None
    e2e = {m["name"]: registry.reader(m["name"])(ob.end_to_end()) for m in bench["end_to_end"]}
    assert min(e2e.values()) > 0


def alter_first_token(out, offset):
    out = out.clone()
    flat = out.view(-1)
    if flat.numel() > offset:
        flat[offset] += 1
    return out


def test_fault_token_altered_in_the_fused_kernel(tmp_path, small_blocks, monkeypatch):
    fused = engine_mod.merge_words_from_bytes_fused

    def broken(tab, raw, lens, u16_out):
        return alter_first_token(fused(tab, raw, lens, u16_out), raw.shape[0])

    monkeypatch.setattr(engine_mod, "merge_words_from_bytes_fused", broken)
    ob = run(tmp_path)
    assert not ob.check["correct"] and ob.check["numbers"]["mismatched_docs"]["value"] > 0


def test_fault_half_of_the_batch_left_out(tmp_path, small_blocks, monkeypatch):
    encode = ht.batch_encode

    def half(texts):
        k = len(texts) // 2
        return encode(texts[:k]) + [[] for _ in texts[k:]]

    monkeypatch.setattr(ht, "batch_encode", half)
    ob = run(tmp_path)
    assert not ob.check["correct"] and ob.check["numbers"]["mismatched_docs"]["value"] > 0


def test_fault_answer_left_unchanged(tmp_path, small_blocks, monkeypatch):
    encode = ht.batch_encode
    first = []

    def stale(texts):
        if not first:
            first.append(encode(texts))
        return first[0]

    monkeypatch.setattr(ht, "batch_encode", stale)
    ob = run(tmp_path)
    assert not ob.check["correct"] and ob.check["numbers"]["mismatched_docs"]["value"] > 0


def test_fault_a_call_that_raises(tmp_path, small_blocks, monkeypatch):
    encode = ht.batch_encode
    n = []

    def flaky(texts):
        n.append(1)
        if len(n) == 3:
            raise RuntimeError("planted")
        return encode(texts)

    monkeypatch.setattr(ht, "batch_encode", flaky)
    ob = run(tmp_path)
    assert not ob.check["correct"] and ob.check["numbers"]["failed_calls"]["value"] == 1


@pytest.mark.parametrize("seed", [2**31 + 3, 7])
def test_the_control_is_not_correct(tmp_path, seed):
    cfg, path = tiny_config(tmp_path)
    r = control.control_run(cfg, path, tiny_traffic(tmp_path), seed, cache=str(tmp_path / "c"))
    assert not r["correct"] and r["numbers"]["mismatched_docs"]["value"] > 0
    assert r["numbers"]["docs_compared"]["value"] == 12


def test_the_table_the_configuration_states_is_enforced(tmp_path):
    cfg, path = tiny_config(tmp_path)
    cfg["table"] = "wide"
    with pytest.raises(registry.BenchError, match="narrow table"):
        harness.run_cell(cfg, path, tiny_traffic(tmp_path), 1, 0.1, False, device="cpu",
                         cache=str(tmp_path / "cache"))


def test_the_cli_refuses_a_run_without_a_card_or_with_steering_variables():
    env = {k: v for k, v in os.environ.items() if not k.startswith("HUTOKEN_TPU_")}
    args = [sys.executable, "-m", "portbench.run", "--workload", CELL,
            "--seed", "1", "--seconds", "1"]
    out = subprocess.run(args, cwd=registry.ROOT, env=dict(env, HUTOKEN_TPU_RAW="1"),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "HUTOKEN_TPU_RAW" in out.stderr
    if torch.cuda.is_available():
        return
    out = subprocess.run(args, cwd=registry.ROOT, env=env, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode != 0 and out.stdout == "" and "no CUDA device" in out.stderr


@pytest.mark.cuda
def test_a_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    env = {k: v for k, v in os.environ.items() if not k.startswith("HUTOKEN_TPU_")}
    out = subprocess.run([sys.executable, "-m", "portbench.run", "--workload", CELL,
                          "--seed", "2", "--seconds", "2", "--trace", "1"],
                         cwd=registry.ROOT, env=env, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
    assert list(line)[-1] == "check" and line["device"]["busy_s"] > 0
    assert "fused_merge_roofline" in line["metrics"]
