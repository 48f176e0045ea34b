"""The port's bench entry point on the CPU, at a small batch.

``python -m zoic_tpu_torch.bench`` compiles its cameras with the port and
times ``create_rays``; on the card it reports rays/s.  Here it runs the
plain versions at ``--batch 4096 --iters 1 --inner 1 --device cpu``, which
checks the flow and the output, not a speed: one parseable JSON line with
``bench.py``'s keys and the device it ran on; ``--all --only thinlens``
runs the three thin-lens cameras; ``--mesh`` splits the headline's batch
over a mesh (of the CPU here, once or twice).  The raster screen samples
equal ``bench.py``'s.
"""

import json

import jax.numpy as jnp
import numpy as np
import pytest

import bench as jax_bench
from zoic_tpu_torch import bench
from _torch_threads import one_thread  # noqa: F401

SMALL = ["--batch", "4096", "--iters", "1", "--inner", "1", "--device", "cpu"]
KEYS = {"metric", "value", "unit", "vs_baseline", "attempts_per_ray",
        "vignetted_frac", "peak_tops", "mfu", "device", "spread"}


def test_headline_prints_one_json_line(capsys):
    bench.main(SMALL)
    out = capsys.readouterr()
    lines = [ln for ln in out.out.splitlines() if ln.strip()]
    assert len(lines) == 1
    res = json.loads(lines[0])
    assert set(res) == KEYS
    assert res["metric"] == "camera_rays_per_sec_chip_double_gauss_f2.0_lut"
    assert res["unit"] == "rays/sec" and res["device"] == "cpu"
    assert res["value"] > 0 and res["peak_tops"] > 0
    assert res["vs_baseline"] == pytest.approx(res["value"] / 1e9)
    assert res["mfu"] == pytest.approx(
        res["value"] * bench.USEFUL_OPS_PER_RAY / (res["peak_tops"] * 1e12))
    assert 1.0 <= res["attempts_per_ray"] <= 3.0
    assert 0.0 <= res["vignetted_frac"] < 0.01
    assert res["spread"] >= 0.0
    assert "compile" in out.err and "peak element-op rate" in out.err


def test_all_only_thinlens(capsys):
    bench.main(SMALL + ["--all", "--only", "thinlens"])
    out = capsys.readouterr()
    assert out.out.strip() == ""  # the headline is filtered out
    names = [ln.split(":")[0].strip() for ln in out.err.splitlines()
             if "rays/s" in ln]
    assert names == ["thinlens_f1.4", "thinlens_vignette",
                     "thinlens_bokeh_image"]


def test_bursts_and_spread_on_every_line(capsys):
    """``--bursts 5``: each camera's line gives its spread over 5 bursts and
    a second line the 5 bursts' device and host times, and nothing else;
    the headline's JSON line has ``spread``, ``(max - min) / median`` of
    the rates."""
    bench.main(SMALL + ["--bursts", "5", "--no-precheck", "--all", "--only",
                        "thinlens_f1.4,headline"])
    out = capsys.readouterr()
    res = json.loads(out.out.strip().splitlines()[-1])
    assert set(res) == KEYS and res["spread"] >= 0.0
    err = out.err.splitlines()
    for name in ("thinlens_f1.4", "headline"):
        line = next(ln for ln in err if ln.strip().startswith(f"{name}:"))
        assert "spread" in line and "over 5 bursts" in line
        detail = next(ln for ln in err
                      if ln.strip().startswith(f"{name} bursts:"))
        columns = detail.split("bursts:")[1].split(";")
        assert [c.strip().rsplit(" ", 1)[0] for c in columns] == [
            "device ms", "host ms"]
        for c in columns:
            times = c.strip().rsplit(" ", 1)[1].split("/")
            assert len(times) == 5 and all(float(t) > 0 for t in times)
    assert bench.spread([2.0, 1.0, 4.0]) == pytest.approx(1.5)
    with pytest.raises(SystemExit):
        bench.main(SMALL + ["--bursts", "0"])


def _headline_line(capsys):
    lines = [ln for ln in capsys.readouterr().out.splitlines() if ln.strip()]
    assert len(lines) == 1
    return json.loads(lines[0])


def test_mesh_is_not_ported(capsys):
    """``--mesh`` is ported: on the CPU the mesh is the one device, and a
    mesh of one reports under the single-card metric, as ``bench.py``
    does."""
    bench.main(SMALL + ["--mesh", "--no-precheck"])
    res = _headline_line(capsys)
    assert set(res) == KEYS and res["device"] == "cpu"
    assert res["metric"] == bench.METRIC
    assert res["vs_baseline"] == pytest.approx(res["value"] / 1e9)
    assert 1.0 <= res["attempts_per_ray"] <= 3.0


def test_mesh_of_two(capsys, monkeypatch):
    """A mesh of two devices reports ``bench.py``'s mesh metric, its
    ``vs_baseline`` per device."""
    monkeypatch.setattr(bench.sharding, "make_mesh",
                        lambda devices=None: bench.sharding.Mesh(["cpu"] * 2))
    bench.main(SMALL + ["--mesh", "--no-precheck"])
    res = _headline_line(capsys)
    assert res["metric"] == "camera_rays_per_sec_mesh2_double_gauss"
    assert res["vs_baseline"] == pytest.approx(res["value"] / 2 / 1e9)
    assert 1.0 <= res["attempts_per_ray"] <= 3.0
    assert 0.0 <= res["vignetted_frac"] < 0.01


def test_cameras_are_bench_py_s():
    cams = bench.configs("disk.npy")
    # bench.py's headline and its eleven extras: three thin-lens cameras
    # and eight raytraced ones
    assert len(cams) == 12 and list(cams)[0] == "headline"
    assert sum(c.lens_model is bench.zt.LensModel.RAYTRACED
               for c in cams.values()) == 9
    assert cams["raytraced_bokeh_image"].use_image


@pytest.mark.parametrize("n", [4096, 1000])
def test_raster_screen_samples_equal_bench_py_s(n):
    sx, sy = bench.screen_samples(n, "cpu")
    jsx, jsy, _, _ = jax_bench._samples(n)
    np.testing.assert_array_equal(sx.numpy(), np.asarray(jsx))
    np.testing.assert_array_equal(sy.numpy(), np.asarray(jsy))
    assert jsx.dtype == jnp.float32


def test_profiling_helpers_on_cpu(tmp_path):
    """``time_fn`` times fresh arguments per call (the host clock on the
    CPU); ``trace`` writes a Chrome trace of the block into its directory."""
    import os

    import torch

    from zoic_tpu_torch.utils import profiling

    made = []

    def make():
        made.append(torch.rand(64))
        return (made[-1],)

    t = profiling.time_fn(torch.sort, make, iters=2, warmup=1, bursts=3,
                          device="cpu")
    assert len(made) == 1 + 2 * 3
    assert 0 < t["min"] <= t["median"] and t["iters"] == 2
    with profiling.trace(str(tmp_path)) as prof:
        torch.ones(1000).cumsum(0)
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    assert any("cumsum" in e.key for e in prof.key_averages())
