"""Seeded data made on the device, at a configuration's full shape.

A frozen copy, in torch, of ``gaussian_classification`` in
``repro_torch/data/tabular.py``: two anisotropic Gaussian classes, a
quarter of the columns multiplied by the next quarter (the
physics-derived interaction features), and a share of labels flipped.
The draws are made in that order on a ``torch.Generator`` of the device,
in a few large calls, so the same seed gives the same data on the same
device.  The generated values stand in for the measured events.
"""

from __future__ import annotations

import numpy as np
import torch


def sub_seed(seed: int, *tags: int) -> int:
    """A 63-bit seed for one purpose (``tags``) of a run's ``seed``."""
    state = np.random.SeedSequence([seed % 2 ** 64, *tags]).generate_state(
        2, np.uint32)
    return (int(state[0]) << 31) ^ int(state[1])


def classification(n: int, f: int, seed: int, device, *, sep: float = 1.2,
                   flip: float = 0.05):
    """(x (n, f) float32, y (n,) float32 in {0, 1}) on ``device``."""
    g = torch.Generator(device=device).manual_seed(seed)
    y = torch.randint(0, 2, (n,), generator=g, device=device)
    means = torch.randn((2, f), generator=g, device=device) * sep
    scales = torch.rand((2, f), generator=g, device=device) * 1.5 + 0.5
    x = torch.randn((n, f), generator=g, device=device)
    x.mul_(scales[y]).add_(means[y])
    k = max(2, f // 4)
    if 2 * k <= f:
        x[:, :k] *= x[:, k:2 * k]
    noise = torch.rand((n,), generator=g, device=device) < flip
    y = torch.where(noise, 1 - y, y).to(torch.float32)
    return x, y
