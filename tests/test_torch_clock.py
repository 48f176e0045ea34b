"""The cold path's clock (``utils.profiling``) on the CPU.

The spans of :data:`profiling.CLOCK_ROOTS` and every span opened inside a
clocked span are timed on ``time.perf_counter_ns`` whether or not a
profiler records; their records are summed by path and traced flag by
``clock_report``.  Here the clock is fed by a patched ``perf_counter_ns``
whose readings are known.  No compile runs: the spans are opened by hand
(``tests/test_torch_spans.py`` runs the port's own paths).
"""

import itertools
from types import SimpleNamespace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from zoic_tpu_torch.utils import profiling


@pytest.fixture(autouse=True)
def clock(monkeypatch):
    """A clock that reads 0, 10, 20, ... ns, one step a reading, on an
    empty record list."""
    ticks = itertools.count(0, 10)
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter_ns=lambda: next(ticks)))
    monkeypatch.setattr(profiling, "_records", [])
    monkeypatch.setattr(profiling, "_dropped", 0)
    return ticks


def _frame(span=profiling.span):
    """A focus change's spans: two phases under the compile, a hot-path
    span under the first."""
    with span("zoic.update"):                      # 0
        with span("zoic.compile"):                 # 10
            with span("zoic.compile.solve"):       # 20
                with span("zoic.camera.create_rays"):  # 30, 40
                    pass
            # solve closes at 50
            with span("zoic.compile.precheck"):    # 60
                pass                               # 70
            # compile closes at 80
        # update closes at 90


def test_wall_and_self_time_by_path():
    _frame()
    got = profiling.clock_report()
    rows = {p: r for (p, traced), r in got["spans"].items() if not traced}
    assert set(rows) == {
        "zoic.update", "zoic.update/zoic.compile",
        "zoic.update/zoic.compile/zoic.compile.solve",
        "zoic.update/zoic.compile/zoic.compile.solve/zoic.camera.create_rays",
        "zoic.update/zoic.compile/zoic.compile.precheck"}
    ns = 1e-9
    solve = rows["zoic.update/zoic.compile/zoic.compile.solve"]
    assert solve["wall_s"] == pytest.approx(30 * ns)
    assert solve["self_s"] == pytest.approx(20 * ns)
    comp = rows["zoic.update/zoic.compile"]
    assert comp["wall_s"] == pytest.approx(70 * ns)
    # the compile's self time and its phases' walls make up its wall
    assert comp["self_s"] == pytest.approx(30 * ns)
    assert rows["zoic.update"]["wall_s"] == pytest.approx(90 * ns)
    assert rows["zoic.update"]["self_s"] == pytest.approx(20 * ns)
    assert all(r["count"] == 1 and r["bytes"] == 0 for r in rows.values())
    assert got["readbacks"] == {} and got["dropped"] == 0


def test_a_span_outside_the_clock_reads_no_clock(monkeypatch):
    """Outside every clocked span a span is the shared no-op context again,
    and nothing reads the clock or keeps a record."""
    def refuse():
        raise AssertionError("the clock was read on the hot path")

    _frame()
    monkeypatch.setattr(profiling, "time",
                        SimpleNamespace(perf_counter_ns=refuse))
    kept = len(profiling._records)
    for name in ("zoic.camera.create_rays", "zoic.raytraced", "zoic.readback"):
        s = profiling.span(name)
        assert s is profiling.span("zoic.totals")
        with s:
            pass
    assert profiling.readback(torch.ones(3))[0].tolist() == [1.0, 1.0, 1.0]
    assert len(profiling._records) == kept


def test_the_traced_flag_under_the_profiler():
    """Spans opened while a profiler records are clocked as traced, and are
    still ``record_function`` ranges in its trace."""
    _frame()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _frame()
    names = [e.name for e in prof.events()]
    assert names.count("zoic.compile.solve") == 1
    assert names.count("zoic.camera.create_rays") == 1
    spans = profiling.clock_report()["spans"]
    for traced in (False, True):
        assert spans[("zoic.update/zoic.compile", traced)]["count"] == 1


def test_since_the_first_focus_change():
    """``since`` leaves out what started before the first root of that
    name: here a compile and a table build of set-up."""
    with profiling.span("zoic.compile"):
        pass
    with profiling.span("zoic.tables.build"):
        pass
    _frame()
    with profiling.span("zoic.tables.build"):
        pass
    spans = profiling.clock_report(since="zoic.update")["spans"]
    assert ("zoic.compile", False) not in spans
    assert spans[("zoic.tables.build", False)]["count"] == 1
    assert spans[("zoic.update/zoic.compile", False)]["count"] == 1
    assert profiling.clock_report(since="zoic.kernel.load")["spans"] == {}
    whole = profiling.clock_report()["spans"]
    assert whole[("zoic.tables.build", False)]["count"] == 2


def test_the_record_list_is_capped_and_counts_the_dropped(monkeypatch):
    monkeypatch.setattr(profiling, "CLOCK_CAP", 4)
    for _ in range(3):
        _frame()
    assert len(profiling._records) == 4
    got = profiling.clock_report()
    assert got["dropped"] == 3 * 5 - 4
    assert sum(r["count"] for r in got["spans"].values()) == 4


def test_reset_drops_the_records(monkeypatch):
    monkeypatch.setattr(profiling, "CLOCK_CAP", 2)
    _frame()
    profiling.clock_reset()
    assert profiling.clock_report() == {"spans": {}, "readbacks": {},
                                        "dropped": 0}
    _frame()
    assert len(profiling._records) == 2


def test_an_exception_closes_the_span():
    with pytest.raises(ValueError):
        with profiling.span("zoic.update"):
            with profiling.span("zoic.compile"):
                raise ValueError("solve failed")
    assert profiling._open == []
    spans = profiling.clock_report()["spans"]
    assert spans[("zoic.update/zoic.compile", False)]["count"] == 1
