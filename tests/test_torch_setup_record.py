"""The port's set-up record (hutoken_tpu_torch/setup_record.py) on the CPU
twins: the stamps a CPU engine's set-up and first calls make, in order;
the caps on calls and on stamps; the process's start read from
``/proc/<pid>/stat`` lines whose command name holds spaces and ``)``;
``/proc/self/status`` read into bytes at the three full stamps (the
package's, the ends of ``device_tables`` and ``warmup``) and not at the
others; the summary's stages and gaps adding up to the
high-water mark; the span record's gauges and rises at a traced call's
end.  No test bounds a time."""

import gc
import os
import subprocess
import sys
import time

import pytest

torch = pytest.importorskip("torch")

from torch.profiler import ProfilerActivity, profile  # noqa: E402

import fixture_tools as ft  # noqa: E402
import hutoken_tpu_torch as hutoken  # noqa: E402
from hutoken_tpu_torch import engine as E  # noqa: E402
from hutoken_tpu_torch import setup_record  # noqa: E402
from hutoken_tpu_torch.setup_record import SETUP as PACKAGE_SETUP  # noqa: E402
from hutoken_tpu_torch.setup_record import (  # noqa: E402
    CALLS,
    SetupRecord,
    parse_status,
    process_start_ns,
    start_ticks,
)
from hutoken_tpu_torch.spans import RECORD, WATCH, pinned_bytes  # noqa: E402

torch.set_num_threads(1)

ENGINE = ["encoder_tables", "device_tables", "replicas", "id_table", "decode_fast_path"]
DOCS = [" ".join(ft.CORPUS.split()[i : i + 40]) for i in range(0, 400, 40)] + ["", "x"]


@pytest.fixture
def rec(monkeypatch):
    """A fresh record in the package's place, a clean span record, and
    small blocks so that the twins' launches run."""
    r = SetupRecord()
    r.read_pinned = pinned_bytes
    monkeypatch.setattr(setup_record, "SETUP", r)
    monkeypatch.setattr(E, "SETUP", r)
    monkeypatch.setattr(hutoken, "_SETUP", r)
    monkeypatch.setitem(E.ROW_BLOCKS, 32, 64)
    monkeypatch.setitem(E.ROW_BLOCKS, 128, 16)
    hutoken._reset()
    RECORD.clear()
    yield r
    hutoken._reset()
    RECORD.clear()


def _set_up(calls: int = 2):
    vocab_path, special_path = ft.write_byte_level_fixture()
    hutoken.initialize(vocab_path, special_path, is_byte_encoder=True, device="cpu")
    engine = hutoken._get_engine()
    engine.warmup()
    for _ in range(calls):
        hutoken.batch_encode(DOCS)
        engine.reset_cache()
    return engine


def _pairs(names):
    return [edge for n in names for edge in (n + ".start", n + ".end")]


def test_a_cpu_engine_stamps_each_stage_in_order(rec):
    _set_up()
    names = [s.name for s in rec.stamps()]
    want = _pairs(["context"] + ENGINE + ["warmup", "call.1", "call.2"])
    assert names == want  # the CPU loads no kernel library


def test_time_and_the_high_water_mark_never_fall(rec):
    _set_up()
    stamps = rec.stamps()
    assert all(a.ns <= b.ns for a, b in zip(stamps, stamps[1:]))
    assert all(s.hwm is not None and s.hwm > 0 for s in stamps)
    assert all(a.hwm <= b.hwm for a, b in zip(stamps, stamps[1:]))
    full = [s for s in stamps if s.name in ("device_tables.end", "warmup.end")]
    assert len(full) == 2 and all(s.rss is not None for s in full)
    if full[0].vm_hwm is not None:  # a kernel that gives the /proc fields
        assert all(a.vm_hwm <= b.vm_hwm for a, b in zip(full, full[1:]))
        assert all(s.anon is not None and s.file is not None for s in full)
    # the other stamps read no status file
    light = [s for s in stamps if s not in full]
    assert light and all(s.vm_hwm is s.rss is s.anon is s.file is s.shmem is None for s in light)
    assert all(s.cost_ns > 0 for s in stamps)


def test_the_pinned_reading_is_none_on_a_cpu_engine(rec):
    _set_up()
    assert PACKAGE_SETUP.read_pinned is pinned_bytes  # the package's own record
    assert pinned_bytes() is None  # CUDA is not initialised
    assert all(s.pinned is None for s in rec.stamps())


def test_only_the_first_untraced_calls_are_stamped(rec):
    _set_up(calls=CALLS + 4)
    calls = [n for n in rec.summary()["stages"] if n.startswith("call.")]
    assert calls == [f"call.{i}" for i in range(1, CALLS + 1)]
    assert rec.calls_made == CALLS and rec.dropped == 0


def test_traced_calls_stamp_the_window_once_and_no_call(rec):
    _set_up(calls=1)
    with profile(activities=[ProfilerActivity.CPU]):
        hutoken.batch_encode(DOCS)
        hutoken.batch_encode(DOCS)
    stamps = rec.stamps()
    names = [s.name for s in stamps]
    assert names.count("window") == 1 and names[-1] == "window"
    assert [n for n in names if n.startswith("call.")] == _pairs(["call.1"])
    assert stamps[-1].rss is None  # no status file
    s = rec.summary()
    assert s["last"] == "window" and s["hwm"] == stamps[-1].hwm
    # the last gap, call.1's end to the window, is kept apart from the gaps
    assert s["to_window"]["hwm_rise"] == stamps[-1].hwm - stamps[-2].hwm
    assert s["to_window"]["seconds"] == (stamps[-1].ns - stamps[-2].ns) / 1e9
    assert "window" not in [g[1] for g in s["gaps"]["between"]]
    outer = sum(v["hwm_rise"] for v in s["stages"].values() if v["outer"])
    assert (s["before_program"]["hwm_rise"] + outer + s["gaps"]["hwm_rise"]
            + s["to_window"]["hwm_rise"] == s["hwm"])


def test_the_cap_keeps_64_stamps_and_counts_the_rest():
    r = SetupRecord()
    for i in range(70):
        r.stamp(f"s{i}")
    assert len(r.stamps()) == 64 and r.dropped == 6
    assert [s.name for s in r.stamps()][-1] == "s63"
    assert r.summary()["dropped"] == 6


def test_stages_and_gaps_add_up_to_the_mark(rec):
    _set_up()
    s = rec.summary()
    assert set(s["stages"]) == set(["context"] + ENGINE + ["warmup", "call.1", "call.2"])
    outer = sum(v["hwm_rise"] for v in s["stages"].values() if v["outer"])
    assert s["before_program"]["hwm_rise"] + outer + s["gaps"]["hwm_rise"] == s["hwm"]
    assert s["to_window"] is None  # no traced call
    seconds = sum(v["seconds"] for v in s["stages"].values() if v["outer"])
    last = rec.stamps()[-1].ns - rec.stamps()[0].ns
    assert seconds + s["gaps"]["seconds"] == pytest.approx(last / 1e9)
    # each gap named by the stamps that bound it
    between = s["gaps"]["between"]
    assert sum(g[3] for g in between) == s["gaps"]["hwm_rise"]
    assert ["decode_fast_path.end", "warmup.start"] in [g[:2] for g in between]


def test_nested_stages_are_not_outer():
    r = SetupRecord()
    with r.stage("engine"):
        with r.stage("device_tables"):
            pass
        r.stamp("engine.note")
    s = r.summary()
    assert s["stages"]["engine"]["outer"] and not s["stages"]["device_tables"]["outer"]
    assert s["gaps"]["between"] == []


def test_an_empty_record_summarises_to_nothing():
    s = SetupRecord().summary()
    assert s["stages"] == {} and s["hwm"] is None and s["stamps"] == []
    assert s["before_program"] is None and s["gaps"] is None


def _stat_line(comm: str, start: int) -> str:
    # fields 3-21, then 22 (the start), then three more
    return f"4242 ({comm}) S " + " ".join(str(i) for i in range(4, 22)) + f" {start} 7 8 9\n"


@pytest.mark.parametrize("comm", ["python3", "my worker", "a) b", ") (", "x) S 1 2 3 ("])
def test_the_start_field_is_counted_after_the_last_parenthesis(comm):
    assert start_ticks(_stat_line(comm, 987654)) == 987654


def test_the_process_start_from_stat_and_uptime(tmp_path):
    hz = os.sysconf("SC_CLK_TCK")
    (tmp_path / "stat").write_text(_stat_line("odd ) name", 50 * hz))
    (tmp_path / "uptime").write_text("80.00 1234.56\n")
    before = time.time_ns()
    got = process_start_ns(str(tmp_path / "stat"), str(tmp_path / "uptime"))
    # started 50 s after boot, 80 s up: 30 s ago
    assert before - 31 * 10**9 < got < before - 29 * 10**9
    assert process_start_ns(str(tmp_path / "none"), str(tmp_path / "uptime")) is None


def test_the_status_fields_are_read_in_bytes_and_none_where_missing(tmp_path):
    text = ("Name:\tpython3\nVmHWM:\t  2048 kB\nVmRSS:\t  1024 kB\n"
            "RssAnon:\t   512 kB\nRssFile:\t   512 kB\n")
    want = (2048 * 1024, 1024 * 1024, 512 * 1024, 512 * 1024, None)
    assert parse_status(text.encode()) == want
    assert parse_status(b"Name:\tpython3\nVmRSS:\t  8 kB\n") == (None, 8192, None, None, None)
    p = tmp_path / "status"
    p.write_text(text)
    r = SetupRecord(status=str(p), start_ns=0)
    r.read_pinned = lambda: 4096
    r.stamp("x", full=True)
    r.stamp("y")
    x, y = r.stamps()
    assert (x.vm_hwm, x.rss, x.anon, x.file, x.shmem, x.pinned) == want + (4096,)
    assert (y.vm_hwm, y.rss, y.anon, y.file, y.shmem, y.pinned) == (None,) * 6
    assert x.hwm > 0 and y.hwm >= x.hwm
    # the mark itself comes from getrusage, which every such kernel gives
    r = SetupRecord(status=str(tmp_path / "none"), start_ns=0)
    r.stamp("x", full=True)
    (x,) = r.stamps()
    assert x.vm_hwm is None and x.rss is None and x.hwm > 0
    assert r.summary()["hwm"] == x.hwm


def test_every_traced_call_reads_its_rise_and_every_eighth_its_stages_and_gauges(rec):
    _set_up(calls=0)
    engine = hutoken._get_engine()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(WATCH + 1):
            hutoken.batch_encode(DOCS)
            engine.reset_cache()
    s = RECORD.summary()
    facade = s["spans"]["facade.batch_encode"]
    assert facade["count"] == facade["marked"] == WATCH + 1
    assert facade["hwm_rise"] >= 0 and facade["hwm_rises"] <= WATCH + 1
    # the first and the ninth call are watched: their stages read the mark
    assert s["spans"]["engine.encode_core"]["marked"] == 2
    assert s["spans"]["engine.reset_cache"]["marked"] == 0
    spans = RECORD.spans()
    assert all((x.hwm0 is not None) == (x.watch or x.name == "facade.batch_encode")
               for x in spans)
    assert len({x.call for x in spans if x.watch}) == 2  # a call is watched whole
    assert all(v["hwm_rise"] >= 0 for v in s["spans"].values())
    gauges = s["gauges"]
    assert gauges["reads"] == 2 and gauges["cost_s"] > 0
    assert gauges["pinned"] is None  # CUDA is not initialised
    if setup_record.heap_free_bytes() is not None:  # glibc
        assert gauges["heap_free"] > 0
    RECORD.clear()
    assert RECORD.summary()["gauges"]["heap_free"] is None


def test_a_watched_call_counts_the_malloc_arenas(rec):
    """``heap.arenas`` rides on the watched calls' ``facade.batch_encode``
    spans and on no other span; how many arenas the cap allows is
    ``tests/test_torch_arenas.py``'s to check, in a fresh process."""
    if setup_record.heap_arenas() is None:
        pytest.skip("no malloc_info: not glibc")
    _set_up(calls=0)
    engine = hutoken._get_engine()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(WATCH + 1):
            hutoken.batch_encode(DOCS)
            engine.reset_cache()
    spans = RECORD.spans()
    counted = [x for x in spans if "heap.arenas" in (x.counts or {})]
    assert len(counted) == 2
    assert all(x.name == "facade.batch_encode" and x.watch and x.parent == 0 for x in counted)
    assert all(x.counts["heap.arenas"] >= 1 for x in counted)
    summed = RECORD.summary()["counts"]["heap.arenas"]
    assert summed == sum(x.counts["heap.arenas"] for x in counted)


def test_the_package_stamp_comes_first_and_below_the_imports_mark():
    code = ("import hutoken_tpu_torch\n"
            "from hutoken_tpu_torch.setup_record import SETUP, parse_status\n"
            "s = SETUP.stamps()[0]\n"
            "now = parse_status(open('/proc/self/status', 'rb').read())[1]\n"
            "print(s.name, s.rss < now,"
            " SETUP.summary()['before_program']['seconds'] > 0)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["package", "True", "True"], out.stderr


def test_the_status_descriptor_is_kept_and_opened_again_in_a_child():
    r = SetupRecord()
    r.stamp("a", full=True)
    fd = r._fd
    r.stamp("b", full=True)
    assert r._fd == fd and os.fstat(fd)
    r._fd_pid = -1  # as a forked child sees it
    r.stamp("c", full=True)
    assert r.stamps()[-1].rss is not None
    del r
    gc.collect()
    with pytest.raises(OSError):
        os.fstat(fd)  # closed with its record


def test_a_forked_child_reads_its_own_status_file():
    code = ("import os\n"
            "from hutoken_tpu_torch.setup_record import SETUP\n"
            "SETUP.stamp('parent', full=True)\n"
            "pid = os.fork()\n"
            "if pid == 0:\n"
            "    SETUP.stamp('child', full=True)\n"
            "    os._exit(0 if SETUP._fd_pid == os.getpid() else 3)\n"
            "_, status = os.waitpid(pid, 0)\n"
            "print(os.waitstatus_to_exitcode(status), SETUP._fd_pid == os.getpid())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert out.stdout.split() == ["0", "True"], out.stderr


def test_the_mark_is_the_process_mark_whichever_thread_raised_it():
    import resource
    import threading

    def grow():
        block = bytearray(64 << 20)
        block[:: 4096] = b"\1" * len(block[:: 4096])  # touch every page

    thread = threading.Thread(target=grow)
    thread.start()
    thread.join()
    assert setup_record.maxrss_bytes() == resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024
