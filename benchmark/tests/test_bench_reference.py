"""The plain reference against the port on the CPU, on a few hundred rays
of both configurations: its compile equals the port's from the same lens
file and draws; its rays equal the port's kernel path (on the CPU, the
kernels' plain versions) bit for bit; and where the port's exact eager
path (``impl="jnp"``) takes the caller's draw, the reference takes it too,
to the same ray."""

import dataclasses

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zt
from benchmark import run
from benchmark.core import cells, inputs
from benchmark.reference import camera as ref_camera
from benchmark.reference import rays as ref_rays

SEED = 2**31 + 1234
N = 384


def _setup(name, **over):
    cell = cells.Cell(name)
    cam = ref_camera.camera_fields({**cell.config["camera"],
                                    "lut_bounds_samples": 2000, **over})
    lens_path = (cell.path("configs/" + cam.lens_file)
                 if hasattr(cam, "lens_file") else None)
    pixels = bokeh_path = None
    if cam.use_image:
        pixels = inputs.bokeh_disk(cam.bokeh_disk)
        bokeh_path = inputs.write_image(
            pixels, f"{cells.ROOT}/build/benchmark/test_disk{cam.bokeh_disk}.npy")
    uniforms = None
    if cam.lens_model == "RAYTRACED":
        uniforms = inputs.compile_uniforms(ref_camera.uniform_shapes(cam),
                                           SEED, "cpu")
    config = run.camera_config(zt, cam, lens_path, bokeh_path)
    g = torch.Generator().manual_seed(SEED)
    u = torch.rand((4, N), generator=g)
    samples = (u[0] * 2 - 1, (u[1] * 2 - 1) * 0.5625, u[2], u[3])
    ref_state = ref_camera.compile_camera(cam, "cpu", lens_path=lens_path,
                                          uniforms=uniforms,
                                          bokeh_pixels=pixels)
    return cam, config, uniforms, samples, ref_state


@pytest.fixture(scope="module", params=["dgauss.frame", "thinlens.frame"])
def setup(request):
    torch.set_num_threads(min(4, torch.get_num_threads()))
    return _setup(request.param)


def _tensors(obj, prefix=""):
    """Every tensor and static field of a state, by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_tensors(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def test_the_compile_equals_the_ports(setup):
    cam, config, uniforms, _, ref_state = setup
    prog = zt.Camera(config, "cpu", uniforms=uniforms).state
    a, b = _tensors(prog), _tensors(ref_state)
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k


def test_the_rays_equal_the_kernel_paths(setup):
    cam, config, uniforms, samples, ref_state = setup
    camera = zt.Camera(config, "cpu", uniforms=uniforms)
    rays, stats = camera.create_rays(*samples, seed=4321)
    ref = ref_rays.create_rays(ref_state, cam, *samples, 4321)
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(rays, f), getattr(ref, f)), f
    assert [int(v) for v in (stats.success, stats.vignetted, stats.tir,
                             stats.tries_total)] == list(ref.counters)
    assert float(ref.margin.min()) >= 0.0
    # in blocks, each keyed by its rays' place in the call: the same rays
    # but for the CPU's vector and scalar loops rounding a few apart
    blocks = ref_rays.create_rays(ref_state, cam, *samples, 4321, block=100)
    assert blocks.counters == ref.counters
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        gap = (getattr(blocks, f) - getattr(ref, f)).abs().max()
        assert float(gap) < 1e-6, f


def test_first_draws_agree_with_the_eager_path(setup):
    cam, config, uniforms, samples, ref_state = setup
    eager = zt.Camera(config.replace(impl="jnp"), "cpu", uniforms=uniforms)
    rays, _ = eager.create_rays(*samples, seed=77)
    ref = ref_rays.create_rays(ref_state, cam, *samples, 77)
    first = (rays.d_ody == 0).all(dim=1)      # the caller's draw held
    assert int(first.sum()) > N // 4
    assert bool(((ref.d_ody[first] == 0).all(dim=1)).all())
    for f in ("origin", "dir"):
        gap = (getattr(rays, f)[first] - getattr(ref, f)[first]).abs().max()
        assert float(gap) < 1e-4, (f, float(gap))
    assert torch.equal(rays.weight[first], ref.weight[first])


def test_the_control_parts_from_the_reference():
    cam, _, _, samples, ref_state = _setup("dgauss.frame")
    ref = ref_rays.create_rays(ref_state, cam, *samples, 5)
    low = ref_rays.create_rays(ref_state, cam, *samples, 5,
                               dtype=torch.bfloat16)
    gap = (low.dir - ref.dir).abs().amax(dim=1)
    assert float(np.median(gap.numpy())) > 1e-3


def test_the_compile_seed_gives_a_default_cameras_draws():
    cell = cells.Cell("dgauss.frame")
    cam = ref_camera.camera_fields({**cell.config["camera"],
                                    "lut_bounds_samples": 2000})
    config = run.camera_config(zt, cam, cell.path("configs/" + cam.lens_file),
                               None)
    default = zt.Camera(config, "cpu").state.lens
    handed = zt.Camera(config, "cpu", uniforms=inputs.compile_uniforms(
        ref_camera.uniform_shapes(cam), 0, "cpu")).state.lens
    a, b = _tensors(default), _tensors(handed)
    assert set(a) == set(b)
    for k in a:
        assert (torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                else a[k] == b[k]), k
    assert cell.config["compile_seed"] == 0
