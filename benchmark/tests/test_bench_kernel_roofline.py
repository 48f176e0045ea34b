"""The raytraced kernel's own roofline share (``metrics/
raytraced_roofline_pct.frame.py`` over ``counts/raytraced_kernel.py``) on a
made-up trace and made-up weights whose numbers are known; where the
events fall under the kernel's time it reads nothing.  And the Petzval
cell at a tiny size on the CPU: a sound run is correct."""

from types import SimpleNamespace

import pytest
import torch

from benchmark.core import cells, peaks, profile
from conftest import tiny_run

METRIC = "raytraced_roofline_pct.frame"
PETZVAL = cells.Cell("petzval.frame")
LENS = PETZVAL.path("configs/" + PETZVAL.config["camera"]["lens_file"])

# two calls of 1e6 rays: the raytraced kernel 0.1 ms and 0.2 ms, the
# epilogue beside it, which the share leaves out
TRACE = profile.Trace(
    ops=[("void (anonymous namespace)::raytraced_kernel<11>(Params)", 0.0,
          1e-4),
         ("(anonymous namespace)::epilogue_kernel", 1e-4, 1.5e-4),
         ("void (anonymous namespace)::raytraced_kernel<11>(Params)", 2e-4,
          4e-4),
         ("(anonymous namespace)::epilogue_kernel", 4e-4, 4.5e-4)],
    spans=[], window_s=5e-4)
SIZES = [1_000_000, 1_000_000]


def _weights(lit):
    w = torch.zeros(1_000_000)
    w[:lit] = 0.5
    return w


# 400,000 lit of the 2,000,000 rays
WEIGHTS = [_weights(150_000), _weights(250_000)]


def _read(events_s=5e-4):
    notes = []
    ctx = SimpleNamespace(
        trace=TRACE,
        traced={"sizes": SIZES, "weights": WEIGHTS, "events_s": events_s},
        cam=None, lens_path=LENS, card="test", note=notes.append)
    return cells.module("metrics", METRIC).read(ctx), notes


def test_the_kernel_floor_of_the_petzval_by_hand():
    count = cells.module("counts", "raytraced_kernel")
    call = cells.module("counts", "raytraced")
    assert call.surfaces(LENS) == (11, 1)
    # normalise 8, eleven hits of 28, ten refractions of 23
    assert call.flops_per_ray(11, 1) == 8 + 11 * 28 + 10 * 23 == 546
    flops, nbytes = count.floor(None, LENS, 1000, 200)
    assert flops == 200 * 546 and nbytes == 1000 * (16 + 32)


def test_the_share_on_a_known_trace():
    value, notes = _read()
    floor, by = peaks.floor_s(400_000 * 546, 2_000_000 * 48)
    assert by == "bytes"
    assert value == pytest.approx(100.0 * floor / 3e-4)
    note = notes[0]
    assert "2000000 rays, 400000 lit (20.0000%)" in note
    assert "0.15 ms a call" in note


def test_nothing_where_events_fall_under_the_kernel():
    value, notes = _read(events_s=2e-4)
    assert value is None and "events >= card >= floor" in notes[-1]


def test_a_sound_petzval_run_is_correct():
    result, log = tiny_run("petzval.frame")
    assert result["correct"] is True
    assert all(c["value"] == 0.0 for c in result["compared"].values())
    assert "pre-check circles, polynomial False" in log
