"""Parity of the port's Theorem 1 machinery with the JAX package's, on the
CPU.

Contracts, with their reasons:

  * the closed forms are the same Python arithmetic: equal;
  * ``rank_error_of_subset`` (a stable order of -f, the first of equal
    bests winning) and ``rank_error_of_binning`` (numpy) are equal to
    JAX's on the same inputs, ties and signed zeros included;
  * the smooth objective, fed the JAX draws' frequencies, phases and
    amplitudes, within 8 float32 ulps of its largest argument (|2 pi f t
    + phase| < 44, an ulp 3.8e-6) in absolute terms: each of the 8
    sinusoids rounds its argument and its sine on its own side, and the
    two ``linspace`` s round their steps differently;
  * the Monte Carlo, on the port's own draws (the JAX streams cannot be
    reproduced), within tests/test_rank_error.py's bounds: rel 0.15 of
    Theorem 1 at 4000 trials, and Fig. 2's rel 0.5 / 0.6.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.core import rank_error as jre
from repro_torch.core import rank_error as re_mod

ARG_ULPS = 8 * float(np.spacing(np.float32(44.0)))


def test_closed_forms_equal():
    for n in (1, 2, 10, 100, 1000, 4096):
        for k in range(1, min(n, 70) + 1):
            assert re_mod.expected_rank_error(n, k) == \
                jre.expected_rank_error(n, k)
            assert re_mod.normalized_rank_error(n, k) == \
                jre.normalized_rank_error(n, k)
    assert re_mod.normalized_rank_error(5, 9) == 0.0
    assert re_mod.normalized_rank_error(1000, 9) == pytest.approx(0.1)
    for n, k in ((10, 0), (3, 4)):
        with pytest.raises(ValueError, match="need 0 < k <= n"):
            re_mod.expected_rank_error(n, k)


def _tied_objective(rng, n):
    f = rng.integers(-3, 4, size=n).astype(np.float32)
    f[rng.random(n) < 0.2] = -0.0
    return f


def test_rank_error_of_subset_equal():
    rng = np.random.default_rng(0)
    n = 50
    for trial in range(120):          # three subset sizes: three compiles
        f = _tied_objective(rng, n) if trial % 2 else \
            rng.normal(size=n).astype(np.float32)
        idx = rng.choice(n, size=(1, 7, n)[trial % 3], replace=False)
        want = int(jre.rank_error_of_subset(jnp.asarray(f),
                                            jnp.asarray(idx)))
        got = re_mod.rank_error_of_subset(torch.from_numpy(f),
                                          torch.from_numpy(idx))
        assert got.shape == () and int(got) == want, trial
    f = torch.tensor([0.1, 5.0, 2.0, 0.3])
    assert int(re_mod.rank_error_of_subset(f, torch.tensor([0, 1]))) == 0
    assert int(re_mod.rank_error_of_subset(f, torch.tensor([3]))) == 2


def test_rank_error_of_binning_equal():
    rng = np.random.default_rng(1)
    for n, k in ((64, 4), (512, 16), (1024, 64)):
        reps = np.floor((np.arange(1, k + 1) * n) / k).astype(int) - 1
        for _ in range(10):
            f = rng.normal(size=n).astype(np.float32)
            assert re_mod.rank_error_of_binning(f, reps) == \
                jre.rank_error_of_binning(f, reps)


@pytest.mark.parametrize("seed", [0, 3, 11])
@pytest.mark.parametrize("n", [200, 1024])
def test_smooth_objective_on_the_jax_draws(seed, n):
    key = jax.random.PRNGKey(seed)
    ks = jax.random.split(key, 3)
    draws = (jax.random.uniform(ks[0], (8,), minval=0.5, maxval=6.0),
             jax.random.uniform(ks[1], (8,), minval=0.0,
                                maxval=2 * jnp.pi),
             jax.random.uniform(ks[2], (8,), minval=0.2, maxval=1.0))
    want = np.asarray(jre.smooth_random_objective(key, n))
    got = re_mod._sinusoids(*(torch.from_numpy(np.array(a)) for a in draws),
                            n)
    assert got.shape == (n,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ARG_ULPS)


def test_smooth_random_objective_draws():
    f = re_mod.smooth_random_objective(torch.Generator().manual_seed(0), 300)
    again = re_mod.smooth_random_objective(torch.Generator().manual_seed(0),
                                           300)
    assert f.shape == (300,) and torch.equal(f, again)
    assert float(f.abs().max()) <= 8.0          # 8 amplitudes <= 1


@pytest.mark.parametrize("n,k", [(200, 4), (200, 16), (500, 9)])
def test_monte_carlo_matches_theorem(n, k):
    """tests/test_rank_error.py's case on the port's draws."""
    gen = torch.Generator().manual_seed(0)
    f = re_mod.smooth_random_objective(gen, n)
    est = re_mod.mc_rank_error_random(gen, f, k, trials=4000)
    assert est.shape == () and est.dtype == torch.float32
    expect = re_mod.expected_rank_error(n, k)
    assert float(est) == pytest.approx(expect, rel=0.15), (float(est),
                                                           expect)


def test_monte_carlo_subsets_are_without_replacement():
    """k = n: every subset is everything, so the argmax is always in it;
    k = 1: the mean rank of a uniform position is (n - 1) / 2 exactly in
    expectation (here within 5 % at 20 000 trials)."""
    f = re_mod.smooth_random_objective(torch.Generator().manual_seed(2), 50)
    gen = torch.Generator().manual_seed(1)
    assert float(re_mod.mc_rank_error_random(gen, f, 50, trials=64)) == 0.0
    est = float(re_mod.mc_rank_error_random(gen, f, 1, trials=20_000))
    assert est == pytest.approx(24.5, rel=0.05)


def test_fig2_quantile_equivalent_to_random():
    """tests/test_rank_error.py's Fig. 2 bounds, on the port's draws."""
    out = re_mod.fig2_experiment(seed=0, n=512, ks=[4, 8, 16], trials=24,
                                 device="cpu")
    assert out["k"] == [4, 8, 16]
    for r, q, t in zip(out["random"], out["quantile"], out["theory"]):
        assert r == pytest.approx(t, rel=0.5)
        assert q == pytest.approx(t, rel=0.6)
        assert abs(r - q) < 0.6 * t + 0.02
    assert out == re_mod.fig2_experiment(seed=0, n=512, ks=[4, 8, 16],
                                         trials=24, device="cpu")


def test_fig2_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        re_mod.fig2_experiment(seed=0, n=64, ks=[4], trials=2)
