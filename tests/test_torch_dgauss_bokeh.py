"""The Double Gauss f/2.0 with a 512 x 512 image bokeh at exposure -0.5
(the benchmark's ``dgauss_bokeh`` configuration) through the port's
``Camera``, against the benchmark's plain reference
(``benchmark/reference``), on the CPU.

Both compile from the lens file, the 512 x 512 disk and the draws the
benchmark makes from the configuration's ``compile_seed`` (fewer LUT
samples, for speed).  The port's state is the reference's bit for bit,
its pre-check fitted over the square the bokeh offsets fill.  The
kernels' tables of the disk, searched as ``csrc/bokeh.cu`` searches them
(``tests/_bokeh_search.py``), give the reference's offsets: the packed
tables and, through their guides, the plane tables on the call's
attempt-0 draws, the plane tables on its retry planes.  Both tables are
too large for an H100 block's shared memory, so both entries take their
global-memory instances, which search the plane tables.  On 2,125 film samples
over the whole frame, among them rays whose retries read a plane cell a
second time, every output and counter of ``Camera.create_rays`` equals
the reference's, and every lit weight is the exposure's factor.  The JAX
package is held to the port's image bokeh in
``test_torch_raytraced_bokeh.py``, not here.
"""

import dataclasses
import json
import os

import pytest
import torch

import zoic_tpu_torch as zt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import bokeh_kernel as bk
from zoic_tpu_torch.ops import trace_kernel as tk
from _bokeh_search import kernel_search, planes_search, sampler_search
from _torch_threads import one_thread  # noqa: F401

from benchmark import run
from benchmark.core import inputs
from benchmark.reference import bokeh as ref_bokeh
from benchmark.reference import camera as ref_camera
from benchmark.reference import rays as ref_rays

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "configs")
N = 16 * 128 + 77
N_LUT = 2000
SEED = inputs.call_seed(123456789012, 0)
H100_SMEM_LIMIT = 232_448  # opt-in shared memory a block, bytes


def _fields(obj, prefix=""):
    """Every tensor and static field of a state, by dotted name."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if isinstance(v, torch.Tensor):
            out[prefix + f.name] = v
        elif dataclasses.is_dataclass(v):
            out.update(_fields(v, prefix + f.name + "."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


@pytest.fixture(scope="module")
def dgauss_bokeh(tmp_path_factory):
    """The port's camera and the reference's state from one lens file, one
    image and one set of compile draws, and one call of each on ``N``
    samples."""
    with open(os.path.join(CONFIGS, "dgauss_bokeh.json")) as f:
        config = json.load(f)
    cam = ref_camera.camera_fields({**config["camera"],
                                    "lut_bounds_samples": N_LUT})
    lens_path = os.path.join(CONFIGS, cam.lens_file)
    pixels = inputs.bokeh_disk(cam.bokeh_disk)
    image_path = inputs.write_image(
        pixels, str(tmp_path_factory.mktemp("bokeh") / "disk512.npy"))
    uniforms = inputs.compile_uniforms(ref_camera.uniform_shapes(cam),
                                       config["compile_seed"], "cpu")
    camera = zt.Camera(run.camera_config(zt, cam, lens_path, image_path),
                       "cpu", uniforms=uniforms)
    ref_state = ref_camera.compile_camera(cam, "cpu", lens_path=lens_path,
                                          uniforms=uniforms,
                                          bokeh_pixels=pixels)
    u = torch.rand((4, N), generator=torch.Generator().manual_seed(7))
    samples = (u[0] * 2 - 1, (u[1] * 2 - 1) * 0.5625, u[2], u[3])
    rays, stats = camera.create_rays(*samples, seed=SEED)
    ref = ref_rays.create_rays(ref_state, cam, *samples, SEED)
    return dict(cam=cam, camera=camera, ref_state=ref_state,
                samples=samples, rays=rays, stats=stats, ref=ref)


def test_the_compile_equals_the_references(dgauss_bokeh):
    a = _fields(dgauss_bokeh["camera"].state)
    b = _fields(dgauss_bokeh["ref_state"])
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], torch.Tensor):
            assert torch.equal(a[k], b[k]), k
        else:
            assert a[k] == b[k], k
    assert a["lens.profile_domain"] == "square"
    assert a["bokeh.height"] == a["bokeh.width"] == 512
    assert float(a["exposure_control"]) == -0.5


def _same_bits(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.view(torch.int32), w.view(torch.int32))


def test_the_packed_tables_give_the_references_offsets(dgauss_bokeh):
    image = dgauss_bokeh["camera"].state.bokeh
    ref = dgauss_bokeh["ref_state"].bokeh
    h, w = image.height, image.width
    packed = bk.packed_tables(image)
    assert packed.numel() == bk.table_floats(h, w) == 2 * h * (w + 2)
    cdf_row, dy_srow, cdf_col, dx_col = bk.table_views(packed, h, w)
    order = ref.row_indices.long()
    assert torch.equal(cdf_row, ref.cdf_row)
    assert torch.equal(dy_srow, ref.dy_srow)
    assert torch.equal(cdf_col[:, :w], ref.cdf_col[order])
    assert torch.equal(dx_col[:, :w], ref.dx_col[order])
    assert not bool(cdf_col[:, w].any() or dx_col[:, w].any())
    _, _, lx, ly = dgauss_bokeh["samples"]
    want = ref_bokeh.sample(ref, lx, ly)
    _same_bits(kernel_search(packed, h, w, lx, ly), want)
    # the sampler's global-memory instance: the plane tables' guides
    _same_bits(sampler_search(bk.plane_tables(image), h, w, lx, ly), want)


def test_the_plane_tables_give_the_references_planes(dgauss_bokeh):
    """The plane entry's whole computation on the call's ``P * Bp`` cells
    (hash, slices, bracketed searches) against the reference's planes."""
    image = dgauss_bokeh["camera"].state.bokeh
    ref = dgauss_bokeh["ref_state"].bokeh
    h, w = image.height, image.width
    t = bk.plane_tables(image)
    assert (t.log2_kr, t.log2_kc) == (12, 9)
    assert t.words.numel() * 4 == bk.smem_bytes(h, w, planes=True)
    n_planes, bp = rt_model.plane_shape(dgauss_bokeh["cam"].max_tries, N)
    assert (n_planes, bp) == (4, N)
    pseed = SEED + rt_model.PLANE_SEED_OFFSET
    ids = torch.arange(n_planes * bp, dtype=torch.int64)
    zero = torch.zeros_like(ids)
    u1 = tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P1)
    u2 = tk.hash_uniform(ids, pseed, zero, rt_model.SALT_P2)
    _same_bits(planes_search(t, h, w, u1, u2),
               ref_rays.planes(ref, n_planes * bp, pseed, ref_rays.SALT_P1,
                               ref_rays.SALT_P2))


@pytest.mark.parametrize("planes,nbytes", [(False, 2_105_344),
                                           (True, 3_170_304)],
                         ids=["sampler", "plane-entry"])
def test_both_entries_search_global_memory(planes, nbytes):
    assert bk.smem_bytes(512, 512, planes) == nbytes
    assert not bk.uses_smem(512, 512, H100_SMEM_LIMIT, planes)


def _counters(stats):
    return [int(v) for v in (stats.success, stats.vignetted, stats.tir,
                             stats.tries_total)]


def test_the_rays_and_counters_equal_the_references(dgauss_bokeh):
    rays, stats, ref = (dgauss_bokeh[k] for k in ("rays", "stats", "ref"))
    for f in ("origin", "dir", "weight", "d_ody", "d_ddy"):
        assert torch.equal(getattr(rays, f), getattr(ref, f)), f
    counters = _counters(stats)
    assert counters == list(ref.counters)
    assert counters[0] + counters[1] == N and counters[3] > 0
    # every lit ray carries the exposure's factor 1 / (1 + 0.25)
    lit = rays.weight != 0
    down = torch.tensor(1.0) / (torch.tensor(1.0) + torch.tensor(0.25))
    assert int(lit.sum()) == counters[0]
    assert bool((rays.weight[lit] == down).all()) and float(down) != 0.8


def test_retries_read_plane_cells_a_second_time(dgauss_bokeh):
    """A ray's k-th retry draw reads plane ``(k - 1) % P``; from the
    ``P + 1``-th on it reads a plane the ray read before, at a shifted
    cell.  Such rays are among the call's, and the port's retries equal
    the reference's there too."""
    camera, rays = dgauss_bokeh["camera"], dgauss_bokeh["rays"]
    state, config = camera.state, camera.config
    sx, sy, lx, ly = dgauss_bokeh["samples"]
    u1, u2, flags = rt_model.kernel_inputs(state, config, lx, ly, SEED)
    origin, _, tries, _ = tk.raytraced_plain(
        state.lens, sx, sy, u1, u2, state.sensor_width, SEED, **flags)
    assert torch.equal(origin, rays.origin)
    n_planes = flags["retry_u1"].shape[0]
    again = tries > n_planes
    assert int(again.sum()) > 0
    assert int(tries.sum()) == _counters(dgauss_bokeh["stats"])[3]
