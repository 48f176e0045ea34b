"""The floor counts of ``counts/``: a tiny camera's floor matches a hand
count, and never exceeds the adds and multiplies the plain reference
does for the same rays."""

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from benchmark.core import cells, peaks
from benchmark.reference import rays as ref_rays
from benchmark.reference.camera import camera_fields

ADDS_MULS = {torch.ops.aten.add.Tensor, torch.ops.aten.sub.Tensor,
             torch.ops.aten.mul.Tensor, torch.ops.aten.rsub.Scalar,
             torch.ops.aten.add.Scalar, torch.ops.aten.sub.Scalar,
             torch.ops.aten.mul.Scalar}


class Count(TorchDispatchMode):
    """Element-wise float adds, subtracts and multiplies, one a lane."""

    def __init__(self):
        super().__init__()
        self.flops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func in ADDS_MULS and out.is_floating_point():
            self.flops += out.numel()
        return out


def _two_surface_lens(tmp_path):
    path = tmp_path / "tiny.dat"
    path.write_text("# a biconvex singlet behind an iris\n"
                    "50.0 5.0 1.5 20.0\n0 5.0 0 10.0\n")
    return str(path)


def test_raytraced_floor_matches_a_hand_count(tmp_path):
    count = cells.module("counts", "raytraced")
    lens = _two_surface_lens(tmp_path)
    assert count.surfaces(lens) == (2, 1)
    # by hand: normalise 3 + 2 + 3; two hits of 28; one refraction of 23
    assert count.flops_per_ray(2, 1) == 8 + 2 * 28 + 23 == 87
    flops, nbytes = count.floor(None, lens, 1000, 600)
    assert flops == 600 * 87 and nbytes == 1000 * 68


def test_raytraced_floor_never_exceeds_the_reference_trace():
    count = cells.module("counts", "raytraced")
    elems = [[1.0, 0.5, 0.1, 100.0, 4.0, 0.7, 1.0, 1.0],
             [5.0, 1.0, 1e-4, 1e8, 4.0, 1.0, float("inf"), 1.0],
             [8.0, 2.0, -0.1, 100.0, 4.0, 1.4, float("inf"), -1.0]]
    one = [torch.tensor([v]) for v in (0.1, 0.2, 0.0, 0.05, 0.0, 1.0)]
    for iris in (-1, 1):
        with Count() as c:
            ref_rays._trace(elems, (), iris, *one)
        floor = count.flops_per_ray(3, 1 if iris >= 0 else 0)
        assert floor <= c.flops, (iris, floor, c.flops)


def test_thinlens_floor_never_exceeds_the_reference():
    count = cells.module("counts", "thinlens")
    cam = camera_fields({"lens_model": "THINLENS", "use_dof": True,
                         "optical_vignetting_distance": 1.0})
    flops, nbytes = count.floor(cam, None, 1, 1)
    assert flops == 31 and nbytes == 68
    u = [torch.tensor([v]) for v in (0.3, -0.2, 0.4, 0.6)]
    with Count() as c:
        ref_rays.thinlens_block(*u, 0.36, 1.78, 100.0, 1.0, 1.0, 7,
                                use_dof=True, has_ov=True, max_tries=0)
    assert flops <= c.flops


def test_the_floor_is_the_larger_of_the_two_times():
    t, by = peaks.floor_s(67e12, 3.35e12 * 2)
    assert (t, by) == (2.0, "bytes")
    t, by = peaks.floor_s(67e12 * 3, 3.35e12)
    assert (t, by) == (3.0, "flops")


def test_the_configured_lens_is_counted_as_published():
    cell = cells.Cell("dgauss.frame")
    lens = cell.path("configs/" + cell.config["camera"]["lens_file"])
    count = cells.module("counts", "raytraced")
    assert count.surfaces(lens) == (11, 1)
    assert count.flops_per_ray(11, 1) == 8 + 11 * 28 + 10 * 23
