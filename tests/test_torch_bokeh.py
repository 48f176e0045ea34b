"""The port's image bokeh against the JAX package's, bit for bit.

* ``zoic_tpu_torch.bokeh.build`` equals ``zoic_tpu.bokeh.build`` on every
  table (host NumPy on both sides), and its ``trace=`` dump is the same
  text.
* ``ops.bokeh_kernel.sample_plain`` equals both ``zoic_tpu.bokeh.sample``
  and the Pallas kernel ``bokeh_kernel.sample_fused(..., interpret=True)``
  on the images of ``tests/test_bokeh_kernel.py``: the disk, a non-square
  48x80 image, zero rows with w % 8 != 0, exact CDF-boundary uniforms and
  a batch of 77.  Offsets are selected, never computed, so the gate is
  equality.
* A JAX state with a bokeh image, saved by ``zoic_tpu.io.state.save``,
  loads into the port with every table equal.
"""

import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import zoic_tpu as zt
import zoic_tpu.bokeh as jbokeh
from zoic_tpu import system as jsys
from zoic_tpu.io import state as jax_state_io
from zoic_tpu.ops import bokeh_kernel as jbk

import zoic_tpu_torch as zpt
from zoic_tpu_torch import bokeh as tbokeh
from zoic_tpu_torch import system
from zoic_tpu_torch.ops import bokeh_kernel as tbk

TABLES = ("cdf_row", "row_indices", "cdf_col", "col_indices", "dx_col",
          "dy_srow")


def _disk(n=64, r=0.8):
    yy, xx = np.mgrid[-1:1:n * 1j, -1:1:n * 1j]
    img = ((xx**2 + yy**2) < r).astype(np.float32)
    return np.stack([img, img, img], -1)


def _nonsquare():
    return np.random.default_rng(3).random((48, 80, 3), dtype=np.float32)


def _zero_rows():
    img = np.random.default_rng(5).random((40, 36, 3), dtype=np.float32)
    img[::3, :, :] = 0.0
    return img


IMAGES = {"disk": _disk, "nonsquare-48x80": _nonsquare,
          "zero-rows-w36": _zero_rows, "disk16": lambda: _disk(16)}


def _assert_tables_equal(got, ref):
    assert (got.width, got.height) == (ref.width, ref.height)
    for f in TABLES:
        g, r = getattr(got, f).numpy(), np.asarray(getattr(ref, f))
        assert g.dtype == r.dtype, f
        np.testing.assert_array_equal(g, r, err_msg=f)


@pytest.mark.parametrize("name", list(IMAGES))
def test_build_bit_equal(name):
    pixels = IMAGES[name]()
    _assert_tables_equal(tbokeh.build(pixels), jbokeh.build(pixels))


@pytest.mark.parametrize("shape", [(12, 9), (12, 9, 1), (12, 9, 2),
                                   (12, 9, 4)])
def test_luminance_channel_fallbacks(shape):
    px = np.random.default_rng(1).random(shape, dtype=np.float32)
    np.testing.assert_array_equal(tbokeh.luminance(px), jbokeh.luminance(px))


def test_build_trace_dump_and_load(tmp_path):
    img = _zero_rows()[:6, :5]
    got, ref = io.StringIO(), io.StringIO()
    tbokeh.build(img, trace=got)
    jbokeh.build(img, trace=ref)
    assert got.getvalue() == ref.getvalue() and "CDF column" in got.getvalue()
    path = str(tmp_path / "img.npy")
    np.save(path, img)
    _assert_tables_equal(tbokeh.load(path), jbokeh.load(path))
    with pytest.raises(ValueError, match="zero total luminance"):
        tbokeh.build(np.zeros((4, 4, 3), np.float32))


def _uniforms(n, seed):
    u = jax.random.uniform(jax.random.PRNGKey(seed), (2, n), jnp.float32)
    return np.array(u[0]), np.array(u[1])


def _boundary_uniforms():
    image = jbokeh.build(_disk(32))
    cdf_row = np.asarray(image.cdf_row)
    cdf_col = np.asarray(image.cdf_col)
    u1 = np.concatenate([cdf_row, cdf_row * 0.999999, [0.0, 1.0]])
    u1 = u1.astype(np.float32)
    picks = cdf_col[np.asarray(image.row_indices)[:len(u1) % 32], 0]
    u2 = np.resize(np.concatenate([cdf_col[:, 7], picks]), len(u1))
    return u1, u2.astype(np.float32)


CASES = {
    "disk-4096": (_disk, lambda: _uniforms(4096, 7)),
    "nonsquare-48x80": (_nonsquare, lambda: _uniforms(2048, 11)),
    "zero-rows-w36": (_zero_rows, lambda: _uniforms(2048, 13)),
    "cdf-boundaries": (lambda: _disk(32), _boundary_uniforms),
    "batch-77": (lambda: _disk(16), lambda: _uniforms(77, 17)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_sample_plain_bit_equal(case):
    make_img, make_u = CASES[case]
    pixels = make_img()
    u1, u2 = make_u()
    jimg, timg = jbokeh.build(pixels), tbokeh.build(pixels)
    dx_j, dy_j = jbokeh.sample(jimg, jnp.asarray(u1), jnp.asarray(u2))
    dx_k, dy_k = jbk.sample_fused(jimg, jnp.asarray(u1), jnp.asarray(u2),
                                  interpret=True)
    before = tbk.launches
    dx_t, dy_t = tbokeh.sample(timg, torch.from_numpy(u1),
                               torch.from_numpy(u2))
    assert tbk.launches == before  # CPU tensors: the plain version ran
    assert dx_t.dtype == dy_t.dtype == torch.float32
    for got, ref in ((dx_t, dx_j), (dy_t, dy_j), (dx_t, dx_k), (dy_t, dy_k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_sample_plain_large_image_and_chunks(monkeypatch):
    """An image beyond the TPU kernel's 128-pixel gate, against the jnp
    sampler, with the plain version's chunking cut small."""
    monkeypatch.setattr(tbk, "_PLAIN_CHUNK", 1000)
    pixels = np.random.default_rng(9).random((256, 8, 3), dtype=np.float32)
    u1, u2 = _uniforms(3000, 19)
    dx_j, dy_j = jbokeh.sample(jbokeh.build(pixels), jnp.asarray(u1),
                               jnp.asarray(u2))
    dx_t, dy_t = tbk.sample_plain(tbokeh.build(pixels), torch.from_numpy(u1),
                                  torch.from_numpy(u2))
    np.testing.assert_array_equal(dx_t.numpy(), np.asarray(dx_j))
    np.testing.assert_array_equal(dy_t.numpy(), np.asarray(dy_j))


def test_state_with_bokeh_round_trips(tmp_path):
    """A thin-lens state with a bokeh image, compiled and saved by the JAX
    package, loads into the port bit for bit (flatten order: the camera
    scalars, then the bokeh tables; ``bokeh_wh`` gives width, height)."""
    pixels = _nonsquare()
    bpath = str(tmp_path / "b.npy")
    np.save(bpath, pixels)
    cfg = zt.CameraConfig(lens_model=zt.LensModel.THINLENS, use_image=True,
                          bokeh_path=bpath, focal_length=5.0, fstop=1.4)
    js = zt.compile_camera(cfg)
    path = str(tmp_path / "cam.npz")
    jax_state_io.save(path, js)
    st = zpt.load_state(path, device="cpu")
    assert st.lens is None
    _assert_tables_equal(st.bokeh, js.bokeh)
    assert (st.bokeh.width, st.bokeh.height) == (80, 48)
    static = jax_state_io._flatten(js)[1]
    names = system.leaf_names(static)
    assert names[-6:] == [f"bokeh.{f}" for f in TABLES]
    assert len(names) == len(jax.tree_util.tree_leaves(js))
    moved = st.to("cpu")
    assert isinstance(moved.bokeh, zpt.BokehImage)
    assert moved.bokeh.width == 80


def test_bokeh_fields_follow_jax_field_order():
    jnames = [f.name for f in dataclasses.fields(jsys.BokehImage)]
    tnames = [f.name for f in dataclasses.fields(system.BokehImage)]
    assert jnames == tnames
    static = [f.name for f in dataclasses.fields(jsys.BokehImage)
              if f.metadata.get("static")]
    assert static == ["width", "height"]
