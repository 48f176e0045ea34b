"""Whole runs on the CPU at a tiny size (the harness's look for a card
skipped; the port runs its kernels' plain versions): every cell comes out
correct as it stands, and not correct with the timed path broken
underneath in each way the cell can break, or with the bfloat16 control
in the program's place."""

import dataclasses
import types

import pytest
import torch

from conftest import tiny_run

CELLS = ["dgauss.frame", "thinlens.frame", "dgauss.bucket", "dgauss.refocus"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
    result, log = tiny_run(cell)
    assert result["correct"] is True, log
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert all(c["value"] == 0.0 for c in result["compared"].values())


@pytest.mark.parametrize("cell", ["dgauss.frame", "thinlens.frame"])
def test_the_control_is_not_correct(cell):
    result, log = tiny_run(cell, control="bf16")
    assert result["correct"] is False, log
    assert result["compared"]["ray_gap"]["value"] > 1e-3


def _wrap(camera, change):
    """Break ``camera.create_rays``: ``change(rays, stats, n)`` edits what
    each call produces."""
    inner = camera.create_rays

    def create_rays(self, sx, sy, lx, ly, **kw):
        rays, stats = inner(sx, sy, lx, ly, **kw)
        return change(rays, stats, sx.shape[0])

    camera.create_rays = types.MethodType(create_rays, camera)


def half_batch(camera):
    """Only the first half of each call's rays is worked out; the second
    half repeats it, and the counters are the first half's doubled."""
    inner = camera.create_rays

    def create_rays(self, sx, sy, lx, ly, **kw):
        h = sx.shape[0] // 2
        rays, stats = inner(sx[:h], sy[:h], lx[:h], ly[:h], **kw)
        n = sx.shape[0]

        def full(t):
            return torch.cat([t, t, t])[:n]

        rays = type(rays)(*(full(getattr(rays, f.name))
                            for f in dataclasses.fields(rays)))
        stats = type(stats)(*(v * 2 for v in (stats.success, stats.vignetted,
                                               stats.tir, stats.tries_total)))
        return rays, stats

    camera.create_rays = types.MethodType(create_rays, camera)


def one_answer(camera):
    """One ray of each call leaves with its direction turned by 1e-3."""
    def change(rays, stats, n):
        d = rays.dir.clone()
        d[n // 3, 0] += 1e-3
        return dataclasses.replace(rays, dir=d), stats
    _wrap(camera, change)


def unchanged_state(camera):
    """``Camera.update`` takes the new config but keeps the compiled state
    of the old focus."""
    def update(self, config):
        self.config = config
    camera.update = types.MethodType(update, camera)


@pytest.mark.parametrize("cell,fault", [
    ("dgauss.frame", half_batch), ("thinlens.frame", half_batch),
    ("dgauss.bucket", half_batch),
    ("dgauss.frame", one_answer), ("thinlens.frame", one_answer),
    ("dgauss.bucket", one_answer),
    ("dgauss.refocus", unchanged_state),
], ids=lambda v: v if isinstance(v, str) else v.__name__)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    result, log = tiny_run(cell, fault=fault)
    assert result["correct"] is False, log
