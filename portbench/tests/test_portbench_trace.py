"""The reduction of a profiler trace: busy seconds as a union, device
seconds by kernel, idle gaps named by the host span, the refusal of a
trace with no device event or missing kernels the counters saw, and the
tracer wrapping the entry a kernel reader names."""

from __future__ import annotations

import sys
import types

import pytest

from portbench.registry import BenchError
from portbench.trace import (CALL_SPAN, CORE_SPAN, Coverage, Tracer, attach_device_times,
                             reduce_trace, union_seconds)


def x(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


EVENTS = [
    x(CALL_SPAN, "user_annotation", 0, 1000),
    x(CORE_SPAN, "user_annotation", 100, 700),
    x("seg_merge_kernel(...)", "kernel", 200, 100),
    x("Memcpy DtoH", "gpu_memcpy", 250, 100),  # overlaps the kernel
    x("seg_merge_kernel(...)", "kernel", 500, 50),
    x("aten::add", "cpu_op", 0, 5000),  # host events are not device time
    x(CALL_SPAN, "user_annotation", 2000, 500),
    x("fill", "gpu_memset", 2100, 10),
]


def test_union_seconds():
    total, merged = union_seconds([(0, 2), (1, 3), (5, 6)])
    assert total == 4 and merged == [[0, 3], [5, 6]]


def test_reduce_trace():
    r = reduce_trace(EVENTS)
    assert r["busy_s"] == pytest.approx((150 + 50 + 10) / 1e6)
    assert r["events"] == 4
    assert r["kernel_s"]["seg_merge_kernel(...)"] == pytest.approx(150e-6)
    assert r["device_ops"][0][0] == "seg_merge_kernel(...)"
    idle = dict(r["idle_gaps"])
    # idle 0-200, 350-500, 550-2100, 2110-2500: inside the core span
    # 100-200, 350-500, 550-800 (500 us); in a call outside it 0-100,
    # 800-1000, 2000-2100, 2110-2500 (790 us); between calls 1000-2000
    assert idle["engine._encode_core"] == pytest.approx(500e-6)
    assert idle["facade: batch_encode outside _encode_core"] == pytest.approx(790e-6)
    assert idle["harness: between calls"] == pytest.approx(1000e-6)
    assert sum(idle.values()) == pytest.approx(2500e-6 - r["busy_s"])


def test_coverage():
    c = Coverage([(0, 10), (20, 30), (5, 12)])
    assert c.within(-5, 40) == 22 and c.within(8, 25) == 9 and c.within(13, 19) == 0


def works():
    return {"seg_merge": {"launches": 2, "in_bytes": 10, "out_ids": 3},
            "fused_merge": {"launches": 0, "in_bytes": 0, "out_ids": 0}}


def test_device_times_attach():
    w = works()
    attach_device_times(w, reduce_trace(EVENTS), {"seg_merge": 2, "fused_merge": 0})
    assert w["seg_merge"]["device_s"] == pytest.approx(150e-6)
    assert w["fused_merge"]["device_s"] == 0


@pytest.mark.parametrize("launched", [2, 0])
def test_a_trace_without_device_events_fails(launched):
    # launched or not: a cell's traced run has to reach the card
    host_only = [e for e in EVENTS if e["cat"] in ("user_annotation", "cpu_op")]
    with pytest.raises(BenchError, match="no device event"):
        attach_device_times(works(), reduce_trace(host_only), {"seg_merge": launched})


def test_a_trace_missing_a_kernel_that_ran_fails():
    copies_only = [e for e in EVENTS if e["cat"] != "kernel"]
    with pytest.raises(BenchError, match="seg_merge launches"):
        attach_device_times(works(), reduce_trace(copies_only), {"seg_merge": 2})


class FakeEngine:
    def _encode_core(self, texts):
        return [owner.entry(t) for t in texts]


owner = types.ModuleType("portbench_fake_owner")
owner.count = 0


def _entry(text):
    owner.count += 1
    return len(text)


owner.entry = _entry


def fake_reader():
    r = types.ModuleType("fake_reader")
    r.KERNEL = "fake"
    r.ENTRY = "portbench_fake_owner:entry"
    r.keep = lambda args, out: (args[0], out)
    r.launches = lambda: owner.count
    r.work = lambda recs: {"launches": len(recs), "in_bytes": sum(o for _t, o in recs),
                           "out_ids": 0}
    return r


def test_the_tracer_wraps_what_a_kernel_reader_names(monkeypatch):
    pytest.importorskip("torch")
    monkeypatch.setitem(sys.modules, "portbench_fake_owner", owner)
    engine = FakeEngine()
    tracer = Tracer(engine, profile=False, kernels=[fake_reader()])
    tracer.install()
    tracer.start()
    assert engine._encode_core(["ab", "cde"]) == [2, 3]
    moved = tracer.stop()
    tracer.uninstall()
    assert moved["launches"] == {"fake": 2} and moved["core_s"] > 0
    assert tracer.works() == {"fake": {"launches": 2, "in_bytes": 5, "out_ids": 0}}
    assert owner.entry is _entry and "_encode_core" not in vars(engine)  # undone
