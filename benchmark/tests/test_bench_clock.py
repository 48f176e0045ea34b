"""The readers of the program's own clock (``core/clock.py``,
``compile_wall_s.refocus`` and ``readback_wait_s.refocus``) on a made-up
``clock_report``, on the program's clock fed by hand, and on a program
that keeps no clock."""

import itertools
from types import SimpleNamespace

import pytest
import torch

from benchmark.core import cells



# the program's clock after a run: set-up's compile (no zoic.update over
# it), two untraced frames and two traced ones; each frame a compile of
# 0.4 s (self 0.1) with two phases, read-backs in two of them, and a table
# build after it
SETUP = {("zoic.compile", False): (1, 5.0, 4.0, 0)}
FRAMES = {
    ("zoic.update", False): (2, 1.0, 0.2, 0),
    ("zoic.update/zoic.compile", False): (2, 0.8, 0.2, 0),
    ("zoic.update/zoic.compile/zoic.compile.solve", False): (2, 0.2, 0.15, 0),
    ("zoic.update/zoic.compile/zoic.compile.solve/zoic.readback", False):
        (4, 0.05, 0.05, 400),
    ("zoic.update/zoic.compile/zoic.compile.precheck", False):
        (2, 0.4, 0.1, 0),
    ("zoic.update/zoic.compile/zoic.compile.precheck/zoic.precheck.covers",
     False): (2, 0.3, 0.2, 0),
    ("zoic.update/zoic.compile/zoic.compile.precheck/zoic.precheck.covers/"
     "zoic.readback", False): (6, 0.1, 0.1, 6000),
    ("zoic.tables.build", False): (2, 0.04, 0.02, 0),
    ("zoic.tables.build/zoic.readback", False): (6, 0.02, 0.02, 1200),
    ("zoic.update", True): (2, 3.0, 0.6, 0),
    ("zoic.update/zoic.compile", True): (2, 2.4, 2.0, 0),
    ("zoic.update/zoic.compile/zoic.compile.solve/zoic.readback", True):
        (4, 9.0, 9.0, 400),
}


def _report(rows):
    return {"spans": {k: {"count": c, "wall_s": w, "self_s": s,
                          "max_s": w / c, "bytes": b}
                      for k, (c, w, s, b) in rows.items()},
            "readbacks": {}, "dropped": 0}


@pytest.fixture
def clock_report(monkeypatch):
    """The program's ``clock_report`` replaced by one that gives ``rows``
    and records what it was asked."""
    from zoic_tpu_torch.utils import profiling
    asked = []

    def use(rows):
        def report(since=None):
            asked.append(since)
            return _report(rows)
        monkeypatch.setattr(profiling, "clock_report", report)
        return asked
    return use


def _read_clock(metric, window=None):
    notes = []
    ctx = SimpleNamespace(window=window or {}, note=notes.append)
    return cells.module("metrics", metric).read(ctx), notes


def test_the_compile_wall_leaves_out_setup_and_the_traced_frames(
        clock_report):
    asked = clock_report({**SETUP, **FRAMES})
    window = {"window_s": 1.2, "calls": 2, "update_s": [0.5, 0.5]}
    wall, notes = _read_clock("compile_wall_s.refocus", window)
    assert asked == ["zoic.update"]
    assert wall == pytest.approx(0.4)
    note = notes[0]
    assert "2 compiles in 2 untraced frames" in note
    # ranked by wall: the pre-check, its covers, the solve
    assert note.index("zoic.compile.precheck wall 0.200000 self 0.050000 "
                      "share 50.00%") < note.index(
        "zoic.precheck.covers wall 0.150000 self 0.100000 share 37.50%") \
        < note.index("zoic.compile.solve wall 0.100000")
    assert "phases and self 1.000000 of the wall" in note
    assert "the compile is 0.8000 of update_s 0.500000" in note
    assert "zoic.tables.build 1 a frame, 0.020000 s" in note
    assert "traced over untraced 3.0000 over 2 traced compiles" in note
    # a frame of 0.6 s less the update's 0.5 and the build's 0.02
    assert "the frame's rest 0.080000 s of a 0.600000 s frame" in note


def test_the_readback_wait_is_a_frames_untraced_readbacks(clock_report):
    clock_report({**SETUP, **FRAMES})
    wait, notes = _read_clock("readback_wait_s.refocus")
    assert wait == pytest.approx((0.05 + 0.1 + 0.02) / 2)
    note = notes[0]
    assert "2 untraced frames, 8 read-backs and 3800 B a frame" in note
    assert "zoic.precheck.covers x3 1000 B 0.050000 s" in note
    assert "zoic.tables.build x3 200 B 0.010000 s" in note


@pytest.mark.parametrize("metric", ["compile_wall_s.refocus",
                                    "readback_wait_s.refocus"])
def test_without_the_programs_clock_nothing_is_read(clock_report,
                                                    monkeypatch, metric):
    from zoic_tpu_torch.utils import profiling
    clock_report(SETUP)      # a clock with no focus change
    assert _read_clock(metric) == (None, [])
    monkeypatch.delattr(profiling, "clock_report")
    assert _read_clock(metric) == (None, [])


def test_the_programs_clock_from_the_first_focus_change(monkeypatch):
    """The program's own clock, fed by hand: set-up's compile and table
    build before the first focus change and a traced frame after the
    untraced ones are left out."""
    from zoic_tpu_torch.utils import profiling
    ticks = itertools.count(0, 1_000_000)
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter_ns=lambda: next(ticks)))
    monkeypatch.setattr(profiling, "_records", [])

    def frame():
        with profiling.span("zoic.update"):
            with profiling.span("zoic.compile"):
                with profiling.span("zoic.compile.solve"):
                    pass
        with profiling.span("zoic.tables.build"):
            pass

    with profiling.span("zoic.compile"):
        pass
    with profiling.span("zoic.tables.build"):
        pass
    for _ in range(3):
        frame()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        frame()
    wall, notes = _read_clock("compile_wall_s.refocus")
    # 1 ms a reading: the compile reads 3 ms, its phase 1 ms of them
    assert wall == pytest.approx(3e-3)
    assert "3 compiles in 3 untraced frames" in notes[0]
    assert "zoic.tables.build 1 a frame, 0.001000 s" in notes[0]
    assert _read_clock("readback_wait_s.refocus")[0] == 0.0
