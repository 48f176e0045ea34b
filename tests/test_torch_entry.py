"""The port's entry points (``zoic_tpu_torch.entry``) against
``__graft_entry__.py``.

* ``__graft_entry__.py`` is read with ``ast``, never imported (that would
  compile a JAX camera): every ``CameraConfig(...)`` it builds, the lens
  inside ``lens_path(...)``, its ray counts, the kernel pass's
  ``max_tries`` and device cap, and the ``PRNGKey`` numbers it passes must
  be the port's configurations and seeds, value for value;
* ``dryrun_multichip(4, device="cpu")`` runs both passes over
  ``["cpu"] * 4`` with their asserts, each pass's stats summing to its 512
  rays; asking for more cards than are visible raises;
* ``entry``'s ``fn`` on the dry run's state, on a slice of the example
  samples, equals ``create_rays`` on the same inputs bit for bit.

One compile (the dry run's, ~10 s on one thread): ``entry`` is run with its
compile handed the dry run's state, and the test checks what it asked for.
Parity of the headline camera with the JAX package is held by
``test_torch_create_rays.py``, ``test_torch_oracle_parity.py`` and
``test_torch_camera.py``.
"""

import ast
import os

import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch import entry as zentry

from _torch_threads import one_thread  # noqa: F401

GRAFT_ENTRY = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "__graft_entry__.py")


def _name(node) -> str:
    return node.attr if isinstance(node, ast.Attribute) else getattr(
        node, "id", "")


def _calls(tree, name):
    """The calls of ``name`` in ``tree``, in source order."""
    return sorted((n for n in ast.walk(tree)
                   if isinstance(n, ast.Call) and _name(n.func) == name),
                  key=lambda n: (n.lineno, n.col_offset))


def _graft_functions():
    with open(GRAFT_ENTRY) as f:
        tree = ast.parse(f.read())
    return {n.name: n for n in tree.body if isinstance(n, ast.FunctionDef)}


def _camera_config(call: ast.Call) -> zpt.CameraConfig:
    """The port's config from the keywords of a JAX ``CameraConfig(...)``."""
    kw = {}
    for k in call.keywords:
        if k.arg == "lens_model":
            kw[k.arg] = zpt.LensModel[_name(k.value)]
        elif k.arg == "lens_data_path":
            assert _name(k.value.func) == "lens_path"
            (lens,) = (ast.literal_eval(a) for a in k.value.args)
            assert lens == zentry.LENS
            kw[k.arg] = zpt.data.lens_path(lens)
        else:
            kw[k.arg] = ast.literal_eval(k.value)
    return zpt.CameraConfig(**kw)


def _assigned(fn: ast.FunctionDef, target: str):
    (value,) = [n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
                and [_name(t) for t in n.targets] == [target]]
    return value


def test_entry_configs_match_graft_entry():
    fns = _graft_functions()
    # entry(): one camera at 10,000 LUT samples, 65,536 rays, keys 0 and 1
    (cfg,) = _calls(fns["entry"], "CameraConfig")
    assert _camera_config(cfg) == zentry.config(zentry.ENTRY_LUT_SAMPLES)
    assert ast.literal_eval(_assigned(fns["entry"], "n")) == zentry.ENTRY_RAYS
    assert [ast.literal_eval(c.args[0])
            for c in _calls(fns["entry"], "PRNGKey")] == [
        zentry.SAMPLE_SEED, zentry.ENTRY_SEED]

    # dryrun_multichip(n): 2,000 LUT samples, 128 rays a device, then the
    # kernel pass on min(n, 4) devices
    dry = fns["dryrun_multichip"]
    (cfg,) = _calls(dry, "CameraConfig")
    assert _camera_config(cfg) == zentry.config(zentry.DRYRUN_LUT_SAMPLES)
    n = _assigned(dry, "n")
    assert isinstance(n.op, ast.Mult) and _name(n.right) == "n_devices"
    assert ast.literal_eval(n.left) == zentry.RAYS_PER_DEVICE
    (replace,) = _calls(dry, "replace")
    assert {k.arg: ast.literal_eval(k.value) for k in replace.keywords} == (
        zentry.KERNEL_PASS)
    (cap,) = _calls(dry, "min")
    assert [_name(cap.args[0]), ast.literal_eval(cap.args[1])] == [
        "n_devices", zentry.KERNEL_PASS_MAX_DEVICES]
    assert [ast.literal_eval(c.args[0]) for c in _calls(dry, "PRNGKey")] == [
        zentry.SAMPLE_SEED, zentry.DRYRUN_SEED, zentry.KERNEL_SAMPLE_SEED,
        zentry.DRYRUN_SEED]


def test_dryrun_multichip_cpu(monkeypatch, capsys):
    with pytest.raises(RuntimeError, match="CUDA cards asked for"):
        zentry.dryrun_multichip(torch.cuda.device_count() + 1)

    dry = zentry.dryrun_multichip(4, device="cpu")
    for stats in (dry.eager, dry.kernel):
        assert int(stats.success) + int(stats.vignetted) == 512
    assert capsys.readouterr().out.splitlines() == [
        f"dryrun_multichip {label} OK: 4 devices, 512 rays, "
        f"success={int(s.success)} vignetted={int(s.vignetted)}"
        for label, s in (("jnp", dry.eager), ("kernel", dry.kernel))]

    # entry() on the CPU, its compile handed the dry run's state
    asked = []
    monkeypatch.setattr(zentry, "compile_camera",
                        lambda cfg, dev: asked.append((cfg, dev)) or dry.state)
    fn, (state, sx, sy, lx, ly, seed) = zentry.entry("cpu")
    cfg = zentry.config(zentry.ENTRY_LUT_SAMPLES)
    assert asked == [(cfg, "cpu")] and state is dry.state
    assert seed == zentry.ENTRY_SEED
    for a, b in zip((sx, sy, lx, ly),
                    zentry.samples(zentry.ENTRY_RAYS, zentry.SAMPLE_SEED,
                                   "cpu")):
        assert a.shape == (zentry.ENTRY_RAYS,) and torch.equal(a, b)
    assert float(sx.min()) >= -1.0 and float(sx.max()) <= 1.0
    assert float(lx.min()) >= 0.0 and float(lx.max()) <= 1.0

    part = [a[:2125].cpu() for a in (sx, sy, lx, ly)]
    origin, direction, weight, vignetted = fn(state, *part, seed)
    rays, stats = zpt.create_rays(state, cfg, *part, seed=seed)
    assert origin.shape == (2125, 3) and vignetted.shape == ()
    for got, want in ((origin, rays.origin), (direction, rays.dir),
                      (weight, rays.weight), (vignetted, stats.vignetted)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
