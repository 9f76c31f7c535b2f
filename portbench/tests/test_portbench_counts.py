"""The kernel byte counts: each real input byte once, each output id once
at 4 bytes, whatever implements the kernel; here on the plain twins."""

from __future__ import annotations

import numpy as np
import pytest

from portbench.harness import vocab_files
from portbench.metrics import _counts
from portbench.reference.bpe import Reference
from tiny import tiny_config

torch = pytest.importorskip("torch")

WORDS = [" import", " self", "__init__", " return", " a", "kutya", " árvíz", "x", " 2026", "_"]


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from hutoken_tpu_torch.context import TokenizerContext
    from hutoken_tpu_torch.tables import build_encoder_tables, device_tables

    tmp = tmp_path_factory.mktemp("counts")
    cfg, path = tiny_config(tmp)
    files = vocab_files(cfg, path, cache=str(tmp / "cache"))
    ctx = TokenizerContext.load(files["vocab"], files["special"], is_byte_encoder=True,
                                merges_file_path=files["merges"])
    tab = device_tables(build_encoder_tables(ctx), ctx, torch.device("cpu"))
    ref = Reference(files["vocab"], files["special"], files["merges"])
    return tab, ref


def test_fused_merge_counts_real_bytes_and_ids(setup):
    from hutoken_tpu_torch.ops.fused_merge import merge_words_from_bytes_fused

    tab, ref = setup
    raw_words = [w.encode() for w in WORDS]
    rows = len(raw_words) + 6  # padding rows of length 0
    raw = np.zeros((rows, 16), dtype=np.uint8)
    lens = np.zeros(rows, dtype=np.int32)
    for i, wb in enumerate(raw_words):
        raw[i, : len(wb)] = np.frombuffer(wb, dtype=np.uint8)
        lens[i] = len(wb)
    lens_t = torch.from_numpy(lens)
    out = merge_words_from_bytes_fused(tab, torch.from_numpy(raw), lens_t, True)
    work = _counts.fused_merge_work([(lens_t, out, rows)])
    assert work == {"launches": 1, "in_bytes": sum(map(len, raw_words)),
                    "out_ids": sum(len(ref.encode_word(w)) for w in WORDS)}
    assert _counts.bound_bytes(work) == work["in_bytes"] + 4 * work["out_ids"]


def test_roofline_share():
    work = {"launches": 2, "in_bytes": 3_000_000, "out_ids": 1_000_000, "device_s": 0.001}
    obs = {"kernels": {"k": work}, "peak_bytes_per_s": 3.35e12}
    assert _counts.roofline_share(obs, "k") == pytest.approx(100 * 7e6 / 3.35e12 / 0.001)
    assert _counts.roofline_share({"kernels": {"k": dict(work, launches=0)},
                                   "peak_bytes_per_s": 3.35e12}, "k") is None
    assert _counts.roofline_share({"kernels": {"k": work}}, "k") is None
    assert _counts.roofline_share({"kernels": {}, "peak_bytes_per_s": 1.0}, "k") is None


def test_peaks():
    assert _counts.peak_bytes_per_s("NVIDIA H100 80GB HBM3") == 3.35e12
    assert _counts.peak_bytes_per_s("some other card") is None
