"""The port's CUDA kernels against their plain PyTorch versions, on a card.

Imports no jax, so it runs on a machine that has PyTorch for CUDA and no
JAX; there ``tests/conftest.py`` (which imports jax) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

Without a card each test skips: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

import zoic_tpu_torch as zpt
from zoic_tpu_torch.ops import trace_kernel as tk

SEED = 12345


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(-1, 1, n), rng.uniform(-1, 1, n),
            rng.uniform(0, 1, n), rng.uniform(0, 1, n)]
    return [torch.from_numpy(c.astype(np.float32)).cuda() for c in cols]


@pytest.fixture
def cuda_state():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    return zpt.load_state(zpt.data.state_path(), device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,max_tries", [(1, 25), (255, 0), (16 * 128 + 77, 6), (100_000, 25)]
)
def test_raytraced_kernel_matches_plain(cuda_state, n, max_tries):
    """tries/tir equal but for at most 1 ray in 10,000 (a borderline
    compare under another build of a math function); payloads of rays
    whose tries agree and are within the budget to 1e-5."""
    st = cuda_state
    args = _inputs(n, seed=n)
    before = tk.launches
    ko, kd, kt, ktir = tk.raytraced_fused(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    assert tk.launches == before + 1
    po, pd, pt, ptir = tk.raytraced_plain(
        st.lens, *args, st.sensor_width, SEED, max_tries=max_tries)
    torch.cuda.synchronize()
    assert ko.is_cuda and kt.dtype == torch.int32
    limit = max(1, n // 10_000)
    assert int((kt != pt).sum()) <= limit
    assert int((ktir != ptir).sum()) <= limit
    same = (kt == pt) & (kt <= max_tries)
    assert float((ko - po)[same].abs().max()) <= 1e-5
    assert float((kd - pd)[same].abs().max()) <= 1e-5


@pytest.mark.cuda
def test_create_rays_on_cuda(cuda_state):
    cfg = zpt.CameraConfig(
        lens_model=zpt.LensModel.RAYTRACED, lens_data_path="double_gauss_f2.0",
        focal_length=5.0, fstop=2.0, focal_distance=100.0,
    )
    sx, sy, lx, ly = _inputs(65_536, seed=1)
    g = torch.Generator(device="cuda").manual_seed(3)
    before = tk.launches
    rays, stats = zpt.create_rays(cuda_state, cfg, sx, sy, lx, ly,
                                  generator=g)
    torch.cuda.synchronize()
    assert tk.launches == before + 1
    assert int(stats.success) + int(stats.vignetted) == 65_536
    assert bool(torch.isfinite(rays.origin).all())
    assert rays.weight.is_cuda and rays.weight.shape == (65_536,)
