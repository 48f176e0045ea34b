"""Every raytraced state shipped with the port against a fresh compile.

``zoic_tpu_torch/data`` holds one ``.v7.npz`` per camera of
``zoic_tpu_torch.data.CAMERAS``, written by
``tools/export_torch_state.py --config NAME``.  Each must equal a fresh
``zoic_tpu.compile_camera`` of its config: arrays to rtol 1e-6 (the
Monte-Carlo LUT and profile builds are deterministic for the default keys;
the tolerance covers host float reassociation), static fields exactly.
The headline camera has its own case in ``test_torch_state.py``.
"""

import dataclasses

import jax
import numpy as np
import pytest

import zoic_tpu as zt
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt

STATIC_FIELDS = (
    "aperture_element", "iris_identity", "dead_frac", "elem_flags",
    "profile_domain", "profile_poly", "count",
)

NAMES = [n for n in zpt.data.CAMERAS if n != "headline"]


def test_cameras_name_the_benchmark_configs():
    """The eight raytraced cameras of ``bench.py --all`` beside the
    headline, and the naive state; one file each."""
    cams = zpt.data.CAMERAS
    assert len(cams) == 10 and len({c.file for c in cams.values()}) == 10
    assert cams["raytraced_bokeh_image"].use_image
    assert not cams["raytraced_naive"].kolb_sampling_lut
    for lens in ("petzval_f1.25", "telephoto_f5.0"):
        assert sorted(c.focal_distance for c in cams.values()
                      if c.lens == lens) == [30.0, 100.0, 1000.0]


@pytest.mark.parametrize("name", NAMES)
def test_shipped_state_matches_fresh_compile(name, tmp_path):
    cam = zpt.data.CAMERAS[name]
    bokeh_path = ""
    if cam.use_image:
        bokeh_path = str(tmp_path / "bokeh_disk64.npy")
        np.save(bokeh_path, zpt.data.bokeh_disk(64))
    fresh = zt.compile_camera(zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path(cam.lens), bokeh_path=bokeh_path,
        **cam.config_kwargs()))
    shipped = jax_state_io.load(zpt.data.state_path(name))
    ref_leaves = jax.tree_util.tree_leaves(fresh)
    got_leaves = jax.tree_util.tree_leaves(shipped)
    assert len(got_leaves) == len(ref_leaves)
    for i, (got, ref) in enumerate(zip(got_leaves, ref_leaves)):
        np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                                   rtol=1e-6, atol=0, err_msg=f"leaf {i}")
    for f in STATIC_FIELDS:
        assert getattr(shipped.lens, f) == getattr(fresh.lens, f), f
    assert shipped.lens.profile.kind == fresh.lens.profile.kind
    assert (shipped.bokeh is None) == (not cam.use_image)
    # the port loads the same file with the same statics
    st = zpt.load_state(zpt.data.state_path(name))
    for f in STATIC_FIELDS:
        assert getattr(st.lens, f) == getattr(fresh.lens, f), f
    assert dataclasses.is_dataclass(st) and st.lens.profile.kind == (
        fresh.lens.profile.kind)
