"""Synthetic tabular datasets standing in for the paper's seven benchmarks.

The paper's datasets (SUSY, Higgs, Hepmass, Wiretap/Mirai, PJM/Dominion)
are not available offline; these generators reproduce their *shape class*
(wide noisy classification, physics-style mixtures, autocorrelated
regression series) at configurable row counts so Table-2-style claims
(random ≈ quantile accuracy, T(S) < T(Q)) can be validated.
"""

from __future__ import annotations

import numpy as np


def gaussian_classification(n: int, f: int, seed: int = 0,
                            sep: float = 1.2, flip: float = 0.05):
    """Two anisotropic Gaussian mixtures + label noise (SUSY/Higgs-like)."""
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 2, n)
    means = rng.normal(0, sep, (2, f))
    scales = rng.uniform(0.5, 2.0, (2, f))
    x = rng.normal(means[y], scales[y]).astype(np.float32)
    # a few non-linear interaction features (physics-derived columns)
    k = max(2, f // 4)
    x[:, :k] = x[:, :k] * x[:, k:2 * k] if 2 * k <= f else x[:, :k]
    noise = rng.random(n) < flip
    y = np.where(noise, 1 - y, y).astype(np.float32)
    return x, y


def friedman1(n: int, f: int = 10, seed: int = 0, noise: float = 1.0):
    """Friedman-1 regression (nonlinear + interactions)."""
    rng = np.random.default_rng(seed)
    x = rng.random((n, max(f, 5))).astype(np.float32)
    y = (10 * np.sin(np.pi * x[:, 0] * x[:, 1]) + 20 * (x[:, 2] - 0.5) ** 2
         + 10 * x[:, 3] + 5 * x[:, 4] + rng.normal(0, noise, n))
    return x[:, :f], y.astype(np.float32)


def ar1_series(n: int, f: int = 10, seed: int = 0, rho: float = 0.98):
    """AR(1) energy-consumption-style series with lag features (PJM-like).

    Non-iid by construction — the paper calls out random sampling handling
    non-iid data; rows are time-ordered, so worker shards see different
    regimes.
    """
    rng = np.random.default_rng(seed)
    e = rng.normal(0, 1, n + f)
    s = np.zeros(n + f)
    for t in range(1, n + f):
        s[t] = rho * s[t - 1] + e[t]
    s = s + 0.2 * np.sin(np.arange(n + f) * 2 * np.pi / 24)   # daily cycle
    s = 100.0 + 10.0 * s      # positive, load-like level (MAPE-meaningful)
    x = np.stack([s[i:i + n] for i in range(f)], 1).astype(np.float32)
    y = s[f:f + n].astype(np.float32)
    return x, y


_REGISTRY = {
    # name -> (generator, task, n_features)  [paper analogue]
    "wiretap-like": (lambda n, s: gaussian_classification(n, 115, s), "class", 115),
    "susy-like": (lambda n, s: gaussian_classification(n, 18, s), "class", 18),
    "higgs-like": (lambda n, s: gaussian_classification(n, 28, s), "class", 28),
    "friedman": (lambda n, s: friedman1(n, 10, s), "reg", 10),
    "pjm-like": (lambda n, s: ar1_series(n, 10, s), "reg", 10),
}

DATASET_NAMES = list(_REGISTRY)


def make_dataset(name: str, n_train: int, n_test: int, seed: int = 0):
    gen, task, _ = _REGISTRY[name]
    x, y = gen(n_train + n_test, seed)
    return (x[:n_train], y[:n_train], x[n_train:], y[n_train:], task)
