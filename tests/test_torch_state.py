"""The port's state loading and the state bridge against the JAX package.

* A state file written by ``zoic_tpu.io.state.save`` loads into the port
  with every array bit-equal and every static field equal.
* The state committed beside the port matches a fresh
  ``zoic_tpu.compile_camera`` of the headline config (floats to rtol 1e-6:
  the Monte-Carlo LUT/profile builds are deterministic for the default
  keys, the tolerance covers host float reassociation; statics exactly).
* ``camera_state_from_numpy`` / ``camera_state_to_numpy`` round-trip.
* Importing the port imports no jax.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import zoic_tpu as zt
from zoic_tpu.io import state as jax_state_io

import zoic_tpu_torch as zpt
from zoic_tpu_torch import system
from zoic_tpu_torch.io import state as torch_state_io

STATIC_FIELDS = (
    "aperture_element", "iris_identity", "dead_frac", "elem_flags",
    "profile_domain", "profile_poly",
)


def _headline_config():
    return zt.CameraConfig(
        lens_model=zt.LensModel.RAYTRACED,
        lens_data_path=zt.data.lens_path("double_gauss_f2.0"),
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
        kolb_sampling_lut=True,
    )


@pytest.fixture(scope="module")
def jax_state():
    return zt.compile_camera(_headline_config())


def _named_arrays(jstate):
    """The JAX state's arrays under the port's leaf names."""
    static = jax_state_io._flatten(jstate)[1]
    leaves = jax.tree_util.tree_leaves(jstate)
    return dict(zip(system.leaf_names(static), leaves)), static


def _get(obj, name):
    for part in name.split("."):
        obj = getattr(obj, part)
    return obj


def test_load_matches_jax_state_bit_for_bit(jax_state, tmp_path):
    path = str(tmp_path / "cam.npz")
    jax_state_io.save(path, jax_state)
    st = torch_state_io.load(path, device="cpu")
    named, static = _named_arrays(jax_state)
    assert len(named) == len(jax.tree_util.tree_leaves(jax_state))
    for name, ref in named.items():
        got = _get(st, name)
        assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref),
                                      err_msg=name)
        assert got.numpy().dtype == np.asarray(ref).dtype, name
    for f in STATIC_FIELDS:
        assert getattr(st.lens, f) == getattr(jax_state.lens, f), f
    assert st.lens.profile.kind == jax_state.lens.profile.kind
    assert st.lens.count == jax_state.lens.count


def test_committed_state_matches_fresh_compile(jax_state):
    st = zpt.load_state(zpt.data.state_path(), device="cpu")
    named, _ = _named_arrays(jax_state)
    for name, ref in named.items():
        np.testing.assert_allclose(
            _get(st, name).numpy(), np.asarray(ref), rtol=1e-6, atol=0,
            err_msg=name,
        )
    for f in STATIC_FIELDS:
        assert getattr(st.lens, f) == getattr(jax_state.lens, f), f
    assert st.lens.profile.kind == jax_state.lens.profile.kind
    # the slice's main path: 11 elements, iris at 5, circles + poly
    assert st.lens.count == 11 and st.lens.aperture_element == 5
    assert st.lens.iris_identity and st.lens.profile_poly
    assert st.lens.profile.kind == "circles"
    assert tuple(st.lens.profile.poly.shape) == (4, 9)


def test_bridge_round_trip():
    """Named numpy arrays -> state -> the same arrays, statics kept."""
    path = zpt.data.state_path()
    with np.load(path, allow_pickle=False) as z:
        static = json.loads(str(z["__static__"]))
        names = system.leaf_names(static)
        arrays = {n: z[f"leaf_{i}"] for i, n in enumerate(names)}
    st = system.camera_state_from_numpy(arrays, static, "cpu").to("cpu")
    for name, ref in arrays.items():
        np.testing.assert_array_equal(_get(st, name).numpy(), ref,
                                      err_msg=name)
    assert list(st.lens.elem_flags) == static["elem_flags"]
    assert st.lens.profile.kind == static["profile_kind"]
    assert st.lens.aperture_element == static["aperture_element"]
    with pytest.raises(ValueError, match="do not match"):
        del arrays["lens.lut.keys"]
        system.camera_state_from_numpy(arrays, static, "cpu")


def _rewrite(src, dst, *, static_update=None, drop_last_leaf=False):
    with np.load(src, allow_pickle=False) as z:
        files = {k: z[k] for k in z.files}
    static = json.loads(str(files.pop("__static__")))
    static.update(static_update or {})
    if drop_last_leaf:
        n = sum(1 for k in files if k.startswith("leaf_"))
        del files[f"leaf_{n - 1}"]
    with open(dst, "wb") as f:
        np.savez(f, __static__=json.dumps(static), **files)


@pytest.mark.parametrize(
    "change,match",
    [
        (dict(static_update={"format": 6}), "unsupported state format"),
        (dict(drop_last_leaf=True), "leaves"),
        # claims a bokeh image but holds no bokeh tables
        (dict(static_update={"has_bokeh": True, "bokeh_wh": [4, 4]}),
         "leaves"),
    ],
    ids=["format", "leaf-count", "bokeh"],
)
def test_load_refuses_other_layouts(tmp_path, change, match):
    dst = str(tmp_path / "bad.npz")
    _rewrite(zpt.data.state_path(), dst, **change)
    with pytest.raises((ValueError, NotImplementedError), match=match):
        torch_state_io.load(dst, device="cpu")


def test_state_fields_follow_jax_field_order():
    """The leaf naming relies on both packages declaring their state
    fields in the same order."""
    from zoic_tpu import system as jsys

    for jcls, tcls in (
        (jsys.CameraState, system.CameraState),
        (jsys.LensSystem, system.LensSystem),
        (jsys.PupilLUT, system.PupilLUT),
        (jsys.PupilProfile, system.PupilProfile),
        (jsys.BokehImage, system.BokehImage),
    ):
        jnames = [f.name for f in dataclasses.fields(jcls)]
        tnames = [f.name for f in dataclasses.fields(tcls)]
        assert sorted(jnames) == sorted(tnames), jcls.__name__
        static = {f.name for f in dataclasses.fields(jcls)
                  if f.metadata.get("static")}
        assert ([n for n in jnames if n not in static]
                == [n for n in tnames if n not in static]), jcls.__name__


def test_port_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys, zoic_tpu_torch, chip_smoke; "
        "[importlib.import_module(m.name) for m in pkgutil.walk_packages("
        "zoic_tpu_torch.__path__, 'zoic_tpu_torch.')]; "
        "assert not any(m == 'jax' or m.startswith('jax.') "
        "for m in sys.modules), 'jax imported'; "
        "assert not any(m == 'zoic_tpu' or m.startswith('zoic_tpu.') "
        "for m in sys.modules), 'zoic_tpu imported'"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
