"""The launch path of the port's camera kernels, as far as the CPU shows it.

No card is needed: what is checked is the Python around a launch.  Every
variant word a shipped camera produces has a template instance in
``csrc/raytraced.cu`` (read from the source's instance list, so a variant
without one fails here and not as a launch error on the card); the
thin-lens scalars kept beside a state are the float32 roundings the plain
version uses; the launch helper's input checks; the persistent grid's size.
"""

import dataclasses
import gc
import itertools
import os
import re
import struct

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.models import raytraced as rt_model
from zoic_tpu_torch.ops import _build, _launch
from zoic_tpu_torch.ops import trace_kernel as tk


def _instances():
    """The variant words ``csrc/raytraced.cu`` instantiates."""
    with open(os.path.join(_build.CSRC, "raytraced.cu")) as f:
        src = f.read()
    m = re.search(r"#define ZOIC_RAYTRACED_INSTANCES\(X\)((?:.*\\\n)*.*)\n",
                  src)
    assert m, "csrc/raytraced.cu has no ZOIC_RAYTRACED_INSTANCES list"
    return [int(w) for w in re.findall(r"X\((\d+)\)", m.group(1))]


# config changes a camera is driven with: as shipped, without the pre-check,
# with naive shaping
CHANGES = {
    "shipped": {},
    "no-precheck": dict(pupil_precheck=False),
    "naive-shaping": dict(kolb_sampling_lut=False),
}


@pytest.mark.parametrize("change", list(CHANGES))
@pytest.mark.parametrize("camera", list(zpt.data.CAMERAS))
def test_shipped_variant_has_a_kernel_instance(camera, change):
    """The flags ``create_rays`` hands the kernel for a shipped state and
    config select a variant word that the source instantiates."""
    cam = zpt.data.CAMERAS[camera]
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED, lens_data_path=cam.lens,
        bokeh_path="disk64.npy" if cam.use_image else "",
        **dict(cam.config_kwargs(), **CHANGES[change]))
    st = zpt.load_state(zpt.data.state_path(camera), device="cpu")
    z = torch.full((64,), 0.5)
    _, _, kw = rt_model.kernel_inputs(st, cfg, z, z, 3)
    v = tk.variant(st.lens, kw["use_lut"], kw["use_profile"],
                   kw["presampled"])
    word = tk.variant_word(v, kw["presampled"])
    assert word in _instances(), (camera, change, v, word)
    # a state stripped of its static element flags selects the same instance
    bare = tk.variant(dataclasses.replace(st.lens, elem_flags=()),
                      kw["use_lut"], kw["use_profile"], kw["presampled"])
    assert bare.flags == () and tk.variant_word(bare, kw["presampled"]) == word


def test_instance_list_is_every_variant_word():
    """The list holds each word :func:`variant_word` can produce once (the
    polynomial and the circle form mean nothing without the pre-check) and
    nothing else."""
    words = set()
    for lut, prof, poly, circ, pre in itertools.product((False, True),
                                                        repeat=5):
        if (poly or circ) and not prof:
            continue
        words.add(tk.variant_word(
            tk.Variant(lut, prof, poly, circ, (), -1), pre))
    got = _instances()
    assert len(got) == len(set(got)) == 20
    assert set(got) == words


def test_static_element_flags_reach_the_kernel_through_its_table():
    """The kernel reads the root's sign and the TIR threshold from its
    element table.  On the shipped states the static flags say what the
    table says, so writing them there changes nothing; flags that differ
    from the table (the plain version follows the flags) override it."""
    for camera in zpt.data.CAMERAS:
        st = zpt.load_state(zpt.data.state_path(camera), device="cpu")
        assert len(st.lens.elem_flags) == st.lens.count
        v = tk.variant(st.lens, False, False, False)
        bare = dataclasses.replace(st.lens, elem_flags=())
        vb = tk.variant(bare, False, False, False)
        want = tk._kernel_tables(bare, st.sensor_width, "cpu", vb)[0]
        got = tk._kernel_tables(st.lens, st.sensor_width, "cpu", v)[0]
        assert got.dtype == np.float32 and got.flags["C_CONTIGUOUS"]
        assert got.tobytes() == want.tobytes()
        np.testing.assert_array_equal(
            want[:, 6:], tk.pack_elements(st.lens).numpy()[:, 6:])
    flipped = dataclasses.replace(
        st.lens, elem_flags=tuple(f ^ 3 for f in st.lens.elem_flags))
    vf = tk.variant(flipped, False, False, False)
    got = tk._kernel_tables(flipped, st.sensor_width, "cpu", vf)[0]
    np.testing.assert_array_equal(got[:, 7], -want[:, 7])
    np.testing.assert_array_equal(got[:, 6] == 1.0, want[:, 6] != 1.0)
    np.testing.assert_array_equal(got[:, :6], want[:, :6])


def _bits(x: float) -> bytes:
    return struct.pack("<f", x)


def test_thinlens_scalars_are_kept_beside_their_state():
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
        focal_distance=100.0, use_dof=True,
        optical_vignetting_distance=6.0, optical_vignetting_radius=0.35)
    st = zpt.compile_camera(cfg, "cpu")
    fields = (st.tan_fov, st.aperture_radius, st.focal_distance,
              st.ov_distance, st.ov_radius)
    got = tk.thinlens_scalars(*fields)
    # bit for bit the float32 roundings thinlens_plain uses
    assert [_bits(g) for g in got] == [
        _bits(tk._f32_scalar(f)) for f in fields]
    assert all(float(np.float32(g)) == g for g in got)
    key = id(st.tan_fov)
    assert key in tk._THIN_SCALARS
    assert tk.thinlens_scalars(*fields) is got  # no second read

    # a new state has its own scalars
    st2 = zpt.compile_camera(dataclasses.replace(cfg, fstop=2.8), "cpu")
    got2 = tk.thinlens_scalars(st2.tan_fov, st2.aperture_radius,
                               st2.focal_distance, st2.ov_distance,
                               st2.ov_radius)
    assert got2[1] == tk._f32_scalar(st2.aperture_radius) != got[1]
    assert got2[0] == got[0]

    # a field written in place, or replaced, is read again
    st.focal_distance.fill_(250.0)
    again = tk.thinlens_scalars(*fields)
    assert again[2] == 250.0 and again[:2] == got[:2]
    swapped = tk.thinlens_scalars(fields[0], st2.aperture_radius, *fields[2:])
    assert swapped[1] == got2[1]

    # plain numbers are rounded and kept nowhere
    n = len(tk._THIN_SCALARS)
    assert tk.thinlens_scalars(0.1, 1, 2, 3, 4)[0] == float(np.float32(0.1))
    assert len(tk._THIN_SCALARS) == n

    # the entry goes with its state
    del st, fields
    gc.collect()
    assert key not in tk._THIN_SCALARS


CHECK_CASES = {
    "dtype": (lambda t: t.double(), r"u2 must be float32 of shape \(8,\) on "
              r"cpu, got torch\.float64 \(8,\) on cpu"),
    "shape": (lambda t: t[:7].clone(), r"u2 must be float32 of shape \(8,\) "
              r"on cpu, got torch\.float32 \(7,\) on cpu"),
    "rank": (lambda t: t.reshape(2, 4), r"u2 must be float32 of shape "
             r"\(8,\) on cpu, got torch\.float32 \(2, 4\) on cpu"),
    "device": (lambda t: t.to("meta"), r"u2 must be float32 of shape \(8,\) "
               r"on cpu, got torch\.float32 \(8,\) on meta"),
    "stride": (lambda t: torch.zeros(16)[::2], r"u2 must be contiguous, got "
               r"stride \(2,\); pass u2\.contiguous\(\)"),
}


@pytest.mark.parametrize("case", list(CHECK_CASES))
def test_launch_helper_refuses_bad_inputs(case):
    change, message = CHECK_CASES[case]
    u1 = torch.zeros(8)
    assert _launch.check_flat((("u1", u1), ("u2", torch.ones(8)))) == (
        8, u1.device)
    with pytest.raises(ValueError, match=message):
        _launch.check_flat((("u1", u1), ("u2", change(torch.ones(8)))))


@pytest.mark.parametrize("model", ["raytraced", "thinlens"])
def test_create_rays_takes_columns_of_a_sample_tensor(model):
    """The entry point makes strided inputs (columns of a ``[B, 2]`` sample
    tensor) contiguous once, so the strict kernel wrappers see what they
    accept; the rays are those of the contiguous columns."""
    if model == "raytraced":
        cfg = zpt.CameraConfig(
            lens_model=zpt.LensModel.RAYTRACED,
            lens_data_path="double_gauss_f2.0", focal_length=5.0, fstop=2.0,
            focal_distance=100.0)
        st = zpt.load_state(zpt.data.state_path(), device="cpu")
    else:
        cfg = zpt.CameraConfig(
            lens_model=zpt.LensModel.THINLENS, focal_length=5.0, fstop=1.4,
            focal_distance=100.0, use_dof=True,
            optical_vignetting_distance=6.0, optical_vignetting_radius=0.35)
        st = zpt.compile_camera(cfg, "cpu")
    rng = np.random.default_rng(11)
    uv = torch.from_numpy(rng.uniform(-1, 1, (200, 2)).astype(np.float32))
    lens = torch.from_numpy(rng.uniform(0, 1, (200, 2)).astype(np.float32))
    seen = []
    fused = tk.raytraced_rays if model == "raytraced" else tk.thinlens_rays
    name = fused.__name__

    def spy(*args, **kw):
        seen.extend(a.is_contiguous() for a in args
                    if isinstance(a, torch.Tensor) and a.shape == (200,))
        return fused(*args, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tk, name, spy)
        got, _ = zpt.create_rays(st, cfg, uv[:, 0], uv[:, 1], lens[:, 0],
                                 lens[:, 1], seed=77)
    want, _ = zpt.create_rays(
        st, cfg, *(c.contiguous() for c in (uv[:, 0], uv[:, 1], lens[:, 0],
                                            lens[:, 1])), seed=77)
    assert len(seen) >= 4 and all(seen)
    assert torch.equal(got.origin, want.origin)
    assert torch.equal(got.dir, want.dir)


def test_launch_helper_allocates_owned_outputs():
    a, b = _launch.empty(torch.device("cpu"), ((5, 3), torch.float32),
                         ((5,), torch.int32))
    assert a.shape == (5, 3) and a.dtype == torch.float32
    assert b.shape == (5,) and b.dtype == torch.int32
    assert a.untyped_storage().data_ptr() != b.untyped_storage().data_ptr()
    assert a.is_contiguous() and a.storage_offset() == 0


@pytest.mark.parametrize("b", [1, 31, 32, 33, 2125, 4096, 135_167, 135_168,
                               135_169, 4_194_304])
@pytest.mark.parametrize("per_sm", [1, 4, 6])
def test_persistent_grid_fits_the_work(b, per_sm):
    """At least one block, never more blocks than the card holds at once,
    and never a block whose first warp has no tile of 32 rays."""
    sms = 132
    grid = tk.persistent_grid(b, sms, per_sm)
    tiles = -(-b // 32)
    assert 1 <= grid <= sms * per_sm
    assert (grid - 1) * tk.WARPS_PER_BLOCK < tiles
    if tiles >= sms * per_sm * tk.WARPS_PER_BLOCK:
        assert grid == sms * per_sm


def test_block_size_agrees_with_the_source():
    with open(os.path.join(_build.CSRC, "raytraced.cu")) as f:
        m = re.search(r"constexpr int kBlock = (\d+);", f.read())
    assert int(m.group(1)) == 32 * tk.WARPS_PER_BLOCK
