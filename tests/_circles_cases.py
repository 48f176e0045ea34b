"""Planted cover traces for the circle fit's tests (CPU and card).

``planted(n_keys, n, seed)`` returns float32 ``lx``, ``ly`` and bool ``ok``
of shape ``[n_keys, n]``: unit-disk offsets accepted inside a shifted,
squashed disk that moves with the key, and four planted keys:

* key 1 accepts nothing (the reject-all circle);
* key 2 accepts every sample;
* key 3 has every sample at the origin, accepted: every centre's circle
  holds every subsampled sample, so every pair ties and the first flat
  index, (-3, 0), must win;
* key 4 accepts only the left half-disk.
"""

import numpy as np


def planted(n_keys: int, n: int, seed: int):
    rng = np.random.default_rng(seed)
    rho = np.sqrt(rng.uniform(0.0, 1.0, (n_keys, n)))
    phi = rng.uniform(-np.pi, np.pi, (n_keys, n))
    lx = (rho * np.cos(phi)).astype(np.float32)
    ly = (rho * np.sin(phi)).astype(np.float32)
    cx = np.linspace(-0.4, 0.4, n_keys)[:, None]
    ok = (lx - cx) ** 2 / 0.5 + ly**2 / 0.8 < 0.6
    ok[1] = False
    ok[2] = True
    lx[3] = 0.0
    ly[3] = 0.0
    ok[3] = True
    ok[4] = lx[4] < 0.0
    return lx, ly, ok
