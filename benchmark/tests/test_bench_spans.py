"""The readers of the program's own spans (``core/spans.py`` and the three
metrics that read it) on a made-up trace whose numbers are known, and on
one that holds no ``zoic.*`` span, as a program without them gives."""

from types import SimpleNamespace

import pytest

from benchmark.core import cells, profile, spans

# two focus-pull frames: the first compile 3 s long with 0.4 s of device
# work inside (two overlapping operations and one alone), the second 1 s
# with 0.2 s; one operation after the first compile, outside it
REFOCUS = profile.Trace(
    ops=[("a", 1.2, 1.4), ("b", 1.3, 1.5), ("c", 2.5, 2.6), ("d", 3.5, 3.6),
         ("e", 5.5, 5.7)],
    spans=[("bench.update", 0.0, 4.0), ("zoic.update", 0.1, 3.9),
           ("zoic.compile", 0.2, 3.2), ("zoic.compile.parse", 0.2, 0.3),
           ("zoic.compile.precheck", 1.0, 3.0),
           ("zoic.precheck.covers", 1.0, 2.0),
           ("zoic.precheck.circles", 2.0, 3.0),
           ("bench.update", 4.5, 6.5), ("zoic.compile", 5.0, 6.0)],
    window_s=7.0)

# two calls of 1 ms and 3 ms; a span outside them is not theirs
FRAME = profile.Trace(
    ops=[("k", 0.5e-3, 1.5e-3)],
    spans=[("zoic.camera.create_rays", 0.0, 1e-3),
           ("zoic.create_rays", 0.1e-3, 0.9e-3),
           ("zoic.epilogue", 0.5e-3, 0.6e-3),
           ("zoic.camera.create_rays", 2e-3, 5e-3),
           ("zoic.create_rays", 2.1e-3, 4.9e-3),
           ("zoic.epilogue", 4e-3, 4.3e-3), ("zoic.update", 6e-3, 7e-3)],
    window_s=8e-3)

BENCH_ONLY = profile.Trace(ops=[("k", 0.0, 1.0)],
                           spans=[("bench.call", 0.0, 2.0)], window_s=3.0)


def _read(metric, trace):
    notes = []
    ctx = SimpleNamespace(trace=trace, note=notes.append)
    return cells.module("metrics", metric).read(ctx), notes


def test_the_compile_splits_into_host_and_card():
    host, notes = _read("compile_host_s.refocus", REFOCUS)
    card, _ = _read("compile_device_s.refocus", REFOCUS)
    assert host == pytest.approx((2.6 + 0.8) / 2)
    assert card == pytest.approx((0.4 + 0.2) / 2)
    assert host + card == pytest.approx((3.0 + 1.0) / 2)
    note = notes[0]
    assert "2 compiles" in note
    # covers: 1 s with 0.3 s of device work, over two frames
    assert "zoic.precheck.covers host 0.350000 card 0.150000" in note
    assert "zoic.compile.parse host 0.050000 card 0.000000" in note
    # 3 s + 1 s of compile, 0.1 s + 2 s of it in its phases
    assert "outside the phases 0.950000 s" in note


def test_the_glue_is_the_mean_call_span():
    us, notes = _read("glue_us_per_call.frame", FRAME)
    assert us == pytest.approx(2000.0)
    note = notes[0]
    assert "2 calls" in note and "max 3000.0" in note
    assert "zoic.create_rays x1 mean 1800.0 max 2800.0" in note
    assert "zoic.epilogue x1 mean 200.0 max 300.0" in note
    assert "zoic.update" not in note
    whole, inner = spans.split(FRAME, "zoic.camera.create_rays")
    assert whole.busy_s == pytest.approx(0.5e-3)
    assert set(inner) == {"zoic.create_rays", "zoic.epilogue"}


@pytest.mark.parametrize("metric", ["compile_host_s.refocus",
                                    "compile_device_s.refocus",
                                    "glue_us_per_call.frame"])
def test_without_the_programs_spans_nothing_is_read(metric):
    assert _read(metric, BENCH_ONLY) == (None, [])


def test_an_idle_gap_takes_the_innermost_program_span():
    """The harness's gap labeller, unchanged, puts the device's idle time
    down to the program's step once the program opens its spans."""
    labels = dict((round(g, 6), name) for name, g in profile.gaps(REFOCUS))
    assert labels == {1.2: "bench.update",           # 0 to 1.2
                      1.0: "zoic.precheck.covers",   # 1.5 to 2.5
                      0.9: "zoic.precheck.circles",  # 2.6 to 3.5
                      1.9: "zoic.update",            # 3.6 to 5.5
                      1.3: "zoic.compile"}           # 5.7 to 7
