"""The fisheye cell and the traces a lit ray.

``fisheye.frame`` at a tiny size on the CPU: it resolves to its files, a
sound run is correct with both gaps 0, and the compile picks the harmonic
pre-check lerped per key (the raytraced kernel's instance 3).
``metrics/traces_per_lit_ray.frame.py`` on made-up calls and made-up
program totals whose numbers are known; nothing where the program counted
no draw or keeps no such counters."""

import filecmp
from types import SimpleNamespace

import pytest
import torch

from benchmark.core import cells, profile
from conftest import tiny_run

METRIC = "traces_per_lit_ray.frame"
FISHEYE = cells.Cell("fisheye.frame")

# two calls of 1,000 rays, 600 and 700 of them lit, on instance 3
TRACE = profile.Trace(
    ops=[("void (anonymous namespace)::raytraced_kernel<3>("
          "(anonymous namespace)::Params)", 0.0, 1e-4),
         ("Memset (Device)", 1e-4, 1.1e-4),
         ("void (anonymous namespace)::raytraced_kernel<3>("
          "(anonymous namespace)::Params)", 2e-4, 3e-4)],
    spans=[], window_s=4e-4)


def _weights(lit):
    w = torch.zeros(1_000)
    w[:lit] = 1.0
    return w


def _read(monkeypatch, totals):
    from zoic_tpu_torch.utils import profiling
    if totals is None:
        monkeypatch.delattr(profiling, "take_counters")
    else:
        monkeypatch.setattr(profiling, "take_counters", lambda: totals)
    notes = []
    ctx = SimpleNamespace(
        trace=TRACE, note=notes.append,
        traced={"sizes": [1_000, 1_000],
                "weights": [_weights(600), _weights(700)], "events_s": 4e-4})
    return cells.module("metrics", METRIC).read(ctx), notes


def test_the_lens_file_is_the_shipped_one():
    shipped = "zoic_tpu_torch/data/lenses/fisheye_muller_f4.0.dat"
    lens = FISHEYE.path("configs/" + FISHEYE.config["camera"]["lens_file"])
    assert filecmp.cmp(lens, f"{cells.ROOT}/{shipped}", shallow=False)
    assert FISHEYE.config["limits"] == {"ray_gap": 1e-3, "counter_gap": 1e-2}


def test_traces_a_lit_ray_on_known_totals(monkeypatch):
    value, notes = _read(monkeypatch, {"zoic.raytraced.draws": 5_200,
                                       "zoic.raytraced.traces": 1_560})
    assert value == pytest.approx(1_560 / 1_300)
    note = notes[0]
    assert "2000 rays, 1300 lit" in note
    assert "2.6 draws and 0.78 traces a ray" in note
    assert "rejected 70.0000% of the draws" in note
    assert note.endswith("kernel <3>")


@pytest.mark.parametrize("totals", [None, {"zoic.raytraced.draws": 0,
                                           "zoic.raytraced.traces": 0}],
                         ids=["no counters", "no draw"])
def test_nothing_without_a_count(monkeypatch, totals):
    value, notes = _read(monkeypatch, totals)
    assert value is None and notes == []


def test_a_sound_fisheye_run_is_correct():
    result, log = tiny_run("fisheye.frame")
    assert result["correct"] is True, log
    assert all(c["value"] == 0.0 for c in result["compared"].values())
    assert "pre-check harmonic, polynomial False" in log
