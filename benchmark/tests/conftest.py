"""Shared pieces of the benchmark's CPU tests: the ``cuda`` marker for the
tests that need a card, and a run of a cell at a tiny size on the CPU,
where the port runs the plain versions of its kernels."""

import io
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# a frame of 16 x 8 pixels at 2 x 2 samples (512 rays a call), buckets of
# 8 x 8; the LUT traced with 2,000 samples a film radius
TINY_TRAFFIC = {"width": 16, "height": 8, "aa_samples": 2, "frames": 2,
                "check_calls": 2, "bucket_size": 8}
TINY_CAMERA = {"lut_bounds_samples": 2000}


# the bucket cell's entries, kept out of BENCHMARK.json while the host's
# speed swings its tail between runs (PERF.md, section 7); its traffic and
# metric files are in place, and the tests drive them
BUCKET_CELL = {
    "workloads": [{"name": "dgauss.bucket", "config": "dgauss_f2",
                   "traffic": "bucket", "chips": 1}],
    "end_to_end": [{"name": "bucket_p95_ms", "unit": "ms", "better": "lower",
                    "source": "host_clock", "workloads": ["dgauss.bucket"]}],
    "per_layer": [
        {"name": "host_us_per_call.bucket", "unit": "us", "better": "lower",
         "source": "host_clock", "layer": "host glue",
         "moves": "bucket_p95_ms", "workloads": ["dgauss.bucket"]},
        {"name": "device_idle_pct.bucket", "unit": "%", "better": "lower",
         "source": "device_trace", "layer": "device",
         "moves": "bucket_p95_ms", "workloads": ["dgauss.bucket"]}],
}


def spec_with_bucket():
    """``BENCHMARK.json`` with the bucket cell's entries added."""
    from benchmark.core import cells
    spec = cells.load_spec()
    for key, rows in BUCKET_CELL.items():
        spec[key] = spec[key] + rows
    return spec


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one")


@pytest.fixture
def cuda():
    """Skip the test without a CUDA card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def tiny_run(workload, seed=123456789012, *, control=None, fault=None,
             camera=None, seconds=0.3):
    """One run of ``workload`` on the CPU at the tiny size: ``(result,
    stderr)``."""
    from benchmark import run
    argv = ["--workload", workload, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", "0"]
    if control:
        argv += ["--control", control]
    log = io.StringIO()
    torch.set_num_threads(min(4, torch.get_num_threads()))
    code, result = run.run(
        run.parse(argv), device="cpu", log=log, fault=fault,
        spec=spec_with_bucket(),
        overrides={"camera": {**TINY_CAMERA, **(camera or {})},
                   "traffic": TINY_TRAFFIC})
    assert code == 0, log.getvalue()
    return result, log.getvalue()
