"""The harness on the CPU: every cell resolves to its files, the files keep
to the benchmark's rules, nothing imports JAX or the JAX package, the
traffic generator's frames and buckets, and the trace reader."""

import ast
import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark.core import cells, inputs, profile
from conftest import spec_with_bucket

BENCH = cells.HERE
ROOT = cells.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
JAX_NAMES = {"jax", "jaxlib", "flax", "zoic_tpu"}


def _spec():
    return cells.load_spec()


@pytest.mark.parametrize("name", [w["name"] for w in spec_with_bucket()[
    "workloads"]])
def test_every_cell_resolves_to_its_files(name):
    cell = cells.Cell(name, spec_with_bucket())
    for rel in cell.files():
        assert os.path.isfile(cell.path(rel)), rel
    for m in cell.end_to_end + cell.per_layer:
        assert callable(cells.module("metrics", m["name"]).read)
    assert callable(cells.module("counts", cell.config["count"]).floor)
    assert set(cell.config["limits"]) == {"ray_gap", "counter_gap"}
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer


def test_spec_keeps_to_the_rules():
    spec = _spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    names = ([c["name"] for c in spec["configs"]]
             + [w["name"] for w in spec["workloads"]]
             + [m["name"] for m in spec["end_to_end"] + spec["per_layer"]])
    assert all(NAME.match(n) for n in names)
    for group in ("configs", "workloads"):
        assert len({r["name"] for r in spec[group]}) == len(spec[group])
    metric_names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["name"] in used and os.path.isfile(os.path.join(ROOT,
                                                                 c["file"]))
        assert c["file"].startswith("benchmark/") and len(c["why"]) <= 200
    pairs = {(w["config"], w["traffic"]) for w in spec["workloads"]}
    assert len(pairs) == len(spec["workloads"])
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    e2e = {m["name"] for m in spec["end_to_end"]}
    for m in spec["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        moved = next(e for e in spec["end_to_end"] if e["name"] == m["moves"])
        assert set(m["workloads"]) <= set(moved.get("workloads", [])) or (
            "workloads" not in moved)


def _imports(path):
    tree = ast.parse(open(path).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def _sources(sub=""):
    for dirpath, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def test_nothing_imports_jax_or_the_jax_package():
    for path in _sources():
        top = {m.split(".")[0] for m in _imports(path)}
        assert not top & JAX_NAMES, (path, top & JAX_NAMES)


def test_the_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        top = {m.split(".")[0] for m in _imports(path)}
        assert "zoic_tpu_torch" not in top and not top & JAX_NAMES, path
    for path in list(_sources("counts")) + [os.path.join(BENCH, "core",
                                                         "check.py")]:
        assert "zoic_tpu_torch" not in {m.split(".")[0]
                                        for m in _imports(path)}, path


def test_the_bucket_order_covers_every_pixel_once():
    order, sizes = inputs.bucket_pixels(1920, 1080, 64)
    assert len(sizes) == 510 and sum(sizes) == 1920 * 1080
    assert np.array_equal(np.sort(order), np.arange(1920 * 1080))
    assert set(sizes) == {64 * 64, 64 * 56}
    assert sizes[-30:] == [64 * 56] * 30
    # the first bucket is the frame's top-left 64 x 64 pixels
    first = order[:4096]
    assert set(first % 1920) == set(range(64))
    assert set(first // 1920) == set(range(64))


def test_frames_come_from_the_seed():
    traffic = {"width": 8, "height": 4, "aa_samples": 3, "frames": 2,
               "order": "raster"}
    a, sizes = inputs.make_frames(traffic, 2**31 + 5, "cpu")
    b, _ = inputs.make_frames(traffic, 2**31 + 5, "cpu")
    c, _ = inputs.make_frames(traffic, 2**31 + 6, "cpu")
    assert sizes == [8 * 4 * 9]
    assert all(torch.equal(x, y) for x, y in zip(a[0], b[0]))
    assert not torch.equal(a[0][2], c[0][2])
    assert not torch.equal(a[0][2], a[1][2])
    sx, sy, lx, ly = a[0]
    assert float(sx.abs().max()) <= 1.0 and float(sy.abs().max()) <= 0.5
    # the nine samples of the first pixel fall in its nine strata
    px = ((sx[:9] + 1) / 2 * 8 * 3).floor()
    assert sorted(px.tolist()) == [0, 0, 0, 1, 1, 1, 2, 2, 2]
    assert 0.0 <= float(lx.min()) and float(ly.max()) < 1.0


def test_call_seeds_are_fresh_and_in_range():
    seeds = [inputs.call_seed(2**31 + 99, k) for k in range(2000)]
    assert all(0 <= s < 2**22 for s in seeds)
    assert len(set(seeds)) > 1990


def test_the_focus_pull_goes_out_and_back():
    sched = inputs.focus_schedule({"focus": {"from_cm": 100.0, "to_cm": 1000.0,
                                             "steps": 24}})
    assert len(sched) == 46
    assert sched[0] == 100.0 and sched[23] == pytest.approx(1000.0)
    assert sched[24] == sched[22] and sched[-1] == sched[1]
    ratios = [b / a for a, b in zip(sched[:23], sched[1:24])]
    assert max(ratios) == pytest.approx(min(ratios))


def _events():
    def x(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    return [x("kernel", "primer", 0, 5),
            x("user_annotation", profile.WINDOW, 100, 100),
            x("user_annotation", "bench.call", 100, 10),
            x("kernel", "camera", 105, 20),
            x("user_annotation", "bench.update", 130, 50),
            x("gpu_memset", "memset", 120, 10),
            x("kernel", "epilogue", 180, 10)]


def test_the_trace_reader():
    tr = profile.parse(_events())
    assert tr.window_s == pytest.approx(100e-6)
    assert [o[0] for o in tr.ops] == ["camera", "memset", "epilogue"]
    assert profile.busy_s(tr) == pytest.approx(35e-6)
    assert profile.device_s(tr) == pytest.approx(40e-6)
    assert profile.idle_pct(tr) == pytest.approx(65.0)
    gaps = profile.gaps(tr)
    assert gaps == [("bench.call", pytest.approx(5e-6)),
                    ("bench.update", pytest.approx(50e-6)),
                    ("none", pytest.approx(10e-6))]
    bd = profile.breakdown(tr)
    assert bd["device_ops"][0][0] == "camera"
    assert bd["idle_gaps"][0] == ["bench.update", pytest.approx(50e-6)]


def test_without_a_card_the_run_fails_and_prints_nothing(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "dgauss.frame", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""


def test_outside_the_repo_the_run_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    folder the port is missing: the run fails before it prints a result
    (driven on the CPU, past the look for a card)."""
    import shutil
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    code = ("import sys; sys.path.insert(0, '.'); from benchmark import run; "
            "a = run.parse(['--workload', 'thinlens.frame', '--seed', '1', "
            "'--seconds', '1', '--trace', '0']); "
            "sys.exit(run.run(a, device='cpu')[0])")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "zoic_tpu_torch" in proc.stderr


def test_the_result_line_on_the_card(cuda):
    proc = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "thinlens.frame", "--seed", str(2**31 + 17), "--seconds", "1",
         "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert set(res["metrics"]) == {"rays_per_s", "setup_s"}
    assert res["device"]["platform"] == "gpu"


def test_a_process_that_loaded_jax_prints_no_result(monkeypatch):
    """A JAX module loaded anywhere in the process by the time the result
    would print refuses the run, compared by whole top-level name
    (``zoic_tpu_torch`` is not ``zoic_tpu``); driven on the CPU."""
    import io
    import types
    from benchmark import run
    from conftest import TINY_CAMERA, TINY_TRAFFIC
    assert run.forbidden_modules() == []

    def load_jax(camera):
        monkeypatch.setitem(sys.modules, "jaxlib.xla_client",
                            types.ModuleType("jaxlib.xla_client"))

    log = io.StringIO()
    code, result = run.run(
        run.parse(["--workload", "thinlens.frame", "--seed", "3",
                   "--seconds", "0.2", "--trace", "0"]), device="cpu",
        log=log, fault=load_jax,
        overrides={"camera": TINY_CAMERA, "traffic": TINY_TRAFFIC})
    assert code == 3 and result is None
    assert "jaxlib" in log.getvalue()
