"""The bokeh kernels' own roofline shares (``metrics/
bokeh_roofline_pct.frame.py`` and ``bokeh_planes_roofline_pct.frame.py``
over ``counts/bokeh.py``): the floors worked out by hand at an HD frame's
18,662,400 rays, the shares on a made-up trace whose numbers are known,
each reading only its own kernel's operations and nothing without them
or where the events fall under the kernel's time.  And the
``dgauss_bokeh`` cell at a tiny size on the CPU: a sound run is
correct."""

from types import SimpleNamespace

import pytest

from benchmark.core import cells, peaks, profile
from conftest import tiny_run

SAMPLER = "bokeh_roofline_pct.frame"
PLANES = "bokeh_planes_roofline_pct.frame"
CAM = SimpleNamespace(bokeh_disk=512, max_tries=25)
B = 1920 * 1080 * 9
# the tables of the 512 x 512 disk: 2 * 512 * 514 floats
TABLES = 8 * 512 * 514

SAMPLER_OP = ("void (anonymous namespace)::bokeh_kernel<false>(float const*, "
              "float const*, float const*, float*, float*, int, int, int, "
              "int, bool)")
PLANES_OP = ("void (anonymous namespace)::bokeh_planes_kernel<false>(float "
             "const*, float*, float*, int, int, int, int, int, int, int, "
             "int, bool, unsigned int, unsigned int, unsigned int)")
RAYTRACED_OP = "void (anonymous namespace)::raytraced_kernel<15>(Params)"


def test_the_floors_by_hand():
    count = cells.module("counts", "bokeh")
    assert TABLES == 2_105_344 == count.tables_bytes(512, 512)
    assert B == 18_662_400
    # four planes of an eighth of the call each
    assert count.plane_cells(25, B) == 4 * 2_332_800 == 9_331_200
    assert count.plane_cells(2, 1000) == 3 * 1000
    assert count.plane_cells(25, 100_000) == 4 * 65_536
    assert count.plane_cells(0, B) == 0
    assert count.sampler_floor(CAM, [B]) == (0, 300_703_744)
    assert 300_703_744 == B * 16 + TABLES
    assert count.planes_floor(CAM, [B]) == (0, 76_754_944)
    assert 76_754_944 == 9_331_200 * 8 + TABLES
    # the tables once a call
    assert count.sampler_floor(CAM, [B, B]) == (0, 2 * 300_703_744)
    assert count.planes_floor(SimpleNamespace(bokeh_disk=512, max_tries=0),
                              [B]) == (0, 0)


def _trace(ops):
    """Two calls: each a sampler launch, a plane launch and the raytraced
    kernel, at the times given."""
    return profile.Trace(ops=ops, spans=[], window_s=5e-3)


# the sampler 0.1 and 0.3 ms, the planes 0.05 and 0.15 ms
OPS = [(SAMPLER_OP, 0.0, 1e-4), (PLANES_OP, 1e-4, 1.5e-4),
       (RAYTRACED_OP, 1.5e-4, 1.8e-3), (SAMPLER_OP, 2e-3, 2.3e-3),
       (PLANES_OP, 2.3e-3, 2.45e-3), (RAYTRACED_OP, 2.45e-3, 4.1e-3)]


def _read(metric, ops=OPS, events_s=5e-3):
    notes = []
    ctx = SimpleNamespace(
        trace=_trace(ops), traced={"sizes": [B, B], "events_s": events_s},
        cam=CAM, card="test", note=notes.append)
    return cells.module("metrics", metric).read(ctx), notes


def test_the_sampler_share_on_a_known_trace():
    value, notes = _read(SAMPLER)
    floor, by = peaks.floor_s(0, 2 * 300_703_744)
    assert by == "bytes"
    assert value == pytest.approx(100.0 * floor / 4e-4)
    assert "0.2 ms a call" in notes[0] and "instance global" in notes[0]


def test_the_planes_share_on_a_known_trace():
    value, notes = _read(PLANES)
    floor, by = peaks.floor_s(0, 2 * 76_754_944)
    assert by == "bytes"
    assert value == pytest.approx(100.0 * floor / 2e-4)
    assert "0.1 ms a call" in notes[0] and "instance global" in notes[0]


def test_the_sampler_ignores_the_plane_entry():
    """Without the sampler's operations its share reads nothing, whatever
    the plane entry's; and the plane entry's share does not count the
    sampler's."""
    no_sampler = [o for o in OPS if o[0] != SAMPLER_OP]
    value, notes = _read(SAMPLER, no_sampler)
    assert value is None and "instance none" in notes[0]
    value, _ = _read(PLANES, no_sampler)
    assert value == pytest.approx(
        100.0 * peaks.floor_s(0, 2 * 76_754_944)[0] / 2e-4)


def test_the_instance_in_the_note():
    shared = [(o[0].replace("<false>", "<true>"), o[1], o[2]) for o in OPS]
    _, notes = _read(SAMPLER, shared)
    assert "instance shared" in notes[0]


@pytest.mark.parametrize("metric", [SAMPLER, PLANES])
def test_nothing_without_the_kernel(metric):
    value, notes = _read(metric, [o for o in OPS if o[0] == RAYTRACED_OP])
    assert value is None and "events >= card >= floor" in notes[-1]


@pytest.mark.parametrize("metric", [SAMPLER, PLANES])
def test_nothing_where_events_fall_under_the_kernel(metric):
    value, notes = _read(metric, events_s=1e-4)
    assert value is None and "events >= card >= floor" in notes[-1]


def test_a_sound_dgauss_bokeh_run_is_correct():
    result, log = tiny_run("dgauss_bokeh.frame")
    assert result["correct"] is True
    assert all(c["value"] == 0.0 for c in result["compared"].values())
    assert "pre-check" in log
