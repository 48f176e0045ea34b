"""The benchmark's ``dgauss_bokeh`` camera on a card: the Double Gauss
f/2.0 with a 512 x 512 image bokeh at exposure -0.5, compiled on the card
from the configuration as the benchmark compiles it, through
``Camera.create_rays``.

Imports no jax; on a machine without JAX leave out ``tests/conftest.py``:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_dgauss_bokeh_cuda.py -q

On 1,048,576 samples in raster order (the middle 546 rows of an HD frame,
one sample a pixel) the call's rays and counters equal, bit for bit, the
plain composition computed on the card: ``sample_plain`` for the
attempt-0 offsets, ``planes_plain`` for the retry planes, then
``raytraced_rays_plain``; every lit weight carries the exposure's factor.
The call takes one launch of the sampler and one of the plane entry, and
both search their tables in global memory (the tables of a 512 x 512
image do not fit a block's shared memory).  Without a card each test
skips: the kernels have no CPU mode.
"""

import json
import os

import pytest
import torch

import zoic_tpu_torch as zt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import bokeh_kernel as bk
from zoic_tpu_torch.ops import trace_kernel as tk

from benchmark import run
from benchmark.core import inputs
from benchmark.reference import camera as ref_camera

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "benchmark", "configs", "dgauss_bokeh.json")
N = 1 << 20
SEED = inputs.call_seed(987654321098, 0)
COUNTERS = ("launches", "global_launches", "plane_launches",
            "plane_global_launches")


@pytest.fixture(scope="module")
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def call(cuda_dev, tmp_path_factory):
    """The configuration's camera compiled on the card, its samples, and
    one call with the bokeh launch counters before and after it."""
    with open(CONFIG) as f:
        config = json.load(f)
    cam = ref_camera.camera_fields(config["camera"])
    lens_path = os.path.join(os.path.dirname(CONFIG), cam.lens_file)
    image_path = inputs.write_image(
        inputs.bokeh_disk(cam.bokeh_disk),
        str(tmp_path_factory.mktemp("bokeh") / "disk512.npy"))
    uniforms = inputs.compile_uniforms(ref_camera.uniform_shapes(cam),
                                       config["compile_seed"], cuda_dev)
    camera = zt.Camera(run.camera_config(zt, cam, lens_path, image_path),
                       cuda_dev, uniforms=uniforms)
    traffic = {"width": 1920, "height": 1080, "aa_samples": 1}
    first = (1080 - N // 1920) // 2 * 1920
    pixels = torch.arange(first, first + N, device=cuda_dev)
    samples = inputs.frame_samples(traffic, pixels,
                                   inputs.generator(SEED, 1, cuda_dev),
                                   cuda_dev)
    torch.cuda.synchronize()
    before = [getattr(bk, c) for c in COUNTERS]
    rays, stats = camera.create_rays(*samples, seed=SEED)
    torch.cuda.synchronize()
    after = [getattr(bk, c) for c in COUNTERS]
    return dict(camera=camera, samples=samples, rays=rays, stats=stats,
                launched=dict(zip(COUNTERS, (a - b for a, b in
                                             zip(after, before)))))


def _plain(camera, sx, sy, lx, ly):
    """``raytraced_rays_plain`` on the plain bokeh offsets and planes."""
    state, config = camera.state, camera.config
    lens = state.lens
    dx, dy = bk.sample_plain(state.bokeh, lx, ly)
    n_planes, bp = rt_model.plane_shape(config.max_tries, sx.shape[0])
    r1, r2 = bk.planes_plain(state.bokeh, n_planes * bp,
                             SEED + rt_model.PLANE_SEED_OFFSET,
                             rt_model.SALT_P1, rt_model.SALT_P2)
    assert lens.profile is not None and lens.profile_domain == "square"
    return tk.raytraced_rays_plain(
        lens, sx, sy, dx, dy, state.sensor_width, SEED,
        state.exposure_control, max_tries=config.max_tries,
        use_lut=bool(config.kolb_sampling_lut), use_profile=True,
        presampled=True, retry_u1=r1.reshape(n_planes, bp),
        retry_u2=r2.reshape(n_planes, bp))


@pytest.mark.cuda
def test_the_call_equals_the_plain_composition(call):
    rays, stats = call["rays"], call["stats"]
    origin, direction, weight, d_ody, d_ddy, counts = _plain(
        call["camera"], *call["samples"])
    torch.cuda.synchronize()
    for name, got, want in (("origin", rays.origin, origin),
                            ("dir", rays.dir, direction),
                            ("weight", rays.weight, weight),
                            ("d_ody", rays.d_ody, d_ody),
                            ("d_ddy", rays.d_ddy, d_ddy)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), (
            name, int((got.view(torch.int32) != want.view(torch.int32))
                      .reshape(N, -1).any(1).sum()))
    got = [int(v) for v in (stats.success, stats.vignetted, stats.tir,
                            stats.tries_total)]
    assert got == counts.tolist()
    assert got[0] + got[1] == N and got[3] > 0
    lit = rays.weight != 0
    down = torch.tensor(1.0) / (torch.tensor(1.0) + torch.tensor(0.25))
    assert int(lit.sum()) == got[0] > 0
    assert bool((rays.weight[lit].cpu() == down).all())


@pytest.mark.cuda
def test_one_launch_of_each_entry_in_global_memory(call):
    assert call["launched"] == {"launches": 1, "global_launches": 1,
                                "plane_launches": 1,
                                "plane_global_launches": 1}
    image = call["camera"].state.bokeh
    assert (image.height, image.width) == (512, 512)
