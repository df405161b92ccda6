"""Parity of the port's proposal strategies and sketches with the JAX
package's, on the CPU.

The same numpy inputs go through both.  Contracts, with their reasons:

  * ``weighted_quantile_candidates`` is bit-equal to the jitted JAX
    function (compared as int32 bit patterns, so NaN and the sign of zero
    count): the port's stable order puts -0.0 and +0.0 level and NaN
    last, as ``jnp.argsort`` does, and its prefix sum is
    ``ref.blocked_prefix``, XLA:CPU's association of ``jnp.cumsum``
    (``torch.cumsum`` associates otherwise).  Lengths up to 100 000 (four
    levels of the blocked prefix), and columns with heavy ties, -0.0,
    NaN and zero weights;
  * ``uniform_range_candidates`` is bit-equal to the jitted JAX function:
    XLA:CPU forms ``t`` as a product with float32(1/(k+1)) and computes
    ``lo + (hi - lo) * t`` as one fused multiply-add, and the port writes
    both out (with two float32 roundings 24 to 785 entries of a grid
    differed);
  * ``gk_quantile_candidates`` and ``exact_candidates`` are numpy copies:
    equal index for index, degenerate features included.

The eager JAX ``propose`` fails on jax 0.9.0, so the JAX side is called
through its candidate functions.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import proposal as jproposal, sketch as jsketch
from repro_torch.core import proposal, sketch


def _bits(a) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32)


def _ties(n, f, seed):
    """Half-integer values (heavy ties), 5 % -0.0 and 5 % +0.0, 2 % NaN;
    uniform weights with 1 % zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, size=(n, f)) * 0.5).astype(np.float32)
    z = rng.random((n, f))
    x[z < 0.05] = -0.0
    x[(z >= 0.05) & (z < 0.1)] = 0.0
    x[rng.random((n, f)) < 0.02] = np.nan
    h = rng.random(n).astype(np.float32)
    h[rng.random(n) < 0.01] = 0.0
    return x, h


def _logistic(n, f, seed):
    """Normal features and the hessians of a logistic round."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, f)).astype(np.float32)
    p = 1 / (1 + np.exp(-rng.normal(size=n)))
    return x, (p * (1 - p)).astype(np.float32)


def _wq_both(x, h, k):
    want = jproposal.weighted_quantile_candidates(jnp.asarray(x),
                                                  jnp.asarray(h), k)
    got = proposal.weighted_quantile_candidates(torch.from_numpy(x),
                                                torch.from_numpy(h), k)
    return np.asarray(want), got


@pytest.mark.parametrize("k", [8, 32, 255])
@pytest.mark.parametrize("make,n,f,seed", [
    (_ties, 17, 3, 0), (_ties, 300, 2, 1), (_ties, 5000, 4, 2),
    (_ties, 50_000, 4, 3), (_logistic, 100_000, 3, 7)])
def test_weighted_quantile_bit_equal(make, n, f, seed, k):
    x, h = make(n, f, seed)
    want, got = _wq_both(x, h, k)
    assert got.shape == (f, k) and got.dtype == torch.float32
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_weighted_quantiles_batch_is_per_feature():
    """One batched call is the per-feature calls, and the JAX sketch's."""
    x, h = _ties(3000, 3, 5)
    xt, ht = torch.from_numpy(x), torch.from_numpy(h)
    batch = sketch.weighted_quantiles(xt.T, ht, 16)
    for j in range(3):
        one = sketch.weighted_quantiles(xt[:, j], ht, 16)
        assert np.array_equal(_bits(one.numpy()), _bits(batch[j].numpy()))
        want = jsketch.weighted_quantiles(jnp.asarray(x[:, j]),
                                          jnp.asarray(h), 16)
        assert np.array_equal(_bits(want), _bits(one.numpy()))


def test_weighted_quantiles_skew():
    """tests/test_sketch.py's check: candidates concentrate where the
    hessian mass is."""
    v = torch.linspace(0.0, 1.0, 1000)
    w = torch.where(v < 0.2, 10.0, 0.1)
    assert float(sketch.weighted_quantiles(v, w, 9).median()) < 0.3
    cu = sketch.weighted_quantiles(v, torch.ones_like(v), 9)
    assert float(cu.median()) == pytest.approx(0.5, abs=0.05)


def test_stable_order_is_jnp_argsort():
    """-0.0 level with +0.0 (so equal keys keep their order), NaN of
    either sign last."""
    x, _ = _ties(2000, 1, 9)
    x = x[:, 0]
    x[::97] = -np.float32(np.nan)
    want = np.asarray(jnp.argsort(jnp.asarray(x)))
    assert np.array_equal(sketch.stable_order(torch.from_numpy(x)).numpy(),
                          want)


def _ur_data(n, f, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, f))
            * rng.uniform(0.1, 100, size=f)).astype(np.float32)


@pytest.mark.parametrize("n,f,k", [(1000, 6, 16), (100_000, 28, 32),
                                   (4000, 6, 255), (5000, 10, 64),
                                   (4000, 6, 32), (20_000, 18, 32)])
def test_uniform_range_bit_equal(n, f, k):
    x = _ur_data(n, f, n + k)
    want = jproposal.uniform_range_candidates(jnp.asarray(x), k)
    got = proposal.uniform_range_candidates(torch.from_numpy(x), k)
    assert got.shape == (f, k) and got.dtype == torch.float32
    assert np.array_equal(_bits(want), _bits(got.numpy()))


@pytest.mark.parametrize("k", [16, 32, 64, 255])
def test_uniform_range_bit_equal_at_edges(k):
    """Constant, NaN, infinite and tiny columns, and the ties set."""
    x, _ = _ties(3000, 3, 11)
    edges = _ur_data(3000, 5, k)
    edges[:, 0] = 2.5                      # constant
    edges[5, 1] = np.inf                   # hi = inf
    edges[7, 2] = -np.inf                  # lo = -inf
    edges[:, 3] *= 1e-30                   # subnormal steps
    edges[:, 4] = np.where(edges[:, 4] > 0, 3e38, -3e38)   # hi - lo = inf
    x = np.concatenate([x, edges], axis=1)
    want = jproposal.uniform_range_candidates(jnp.asarray(x), k)
    got = proposal.uniform_range_candidates(torch.from_numpy(x), k)
    assert np.array_equal(_bits(want), _bits(got.numpy()))


def test_fma32_rounds_once():
    """``_fma32`` against the exact sum rounded once (float64 products of
    float32 values are exact; the sum is exact in Python's fractions)."""
    from fractions import Fraction
    rng = np.random.default_rng(0)
    a, b, c = (rng.normal(size=400).astype(np.float32)
               * np.float32(10.0) ** rng.integers(-6, 6, size=400)
               .astype(np.float32) for _ in range(3))
    got = proposal._fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    for i in range(400):
        exact = Fraction(float(a[i])) + Fraction(float(b[i])) * Fraction(
            float(c[i]))
        want = np.float32(float(exact))          # float64 of the exact sum,
        lo, hi = np.nextafter(want, -np.inf), np.nextafter(want, np.inf)
        # then the float32 nearest the exact sum among its neighbours
        best = min((want, lo, hi), key=lambda v: abs(Fraction(float(v))
                                                     - exact))
        assert got[i] == best, i


def _gk_inputs():
    rng = np.random.default_rng(4)
    normal = rng.normal(size=(3000, 3)).astype(np.float32)
    ties, _ = _ties(3000, 3, 4)
    ties = np.nan_to_num(ties)            # GK's bisect needs an order
    return np.concatenate([normal, ties], axis=1)


@pytest.mark.parametrize("k", [4, 16, 32])
def test_gk_quantile_equal_index_for_index(k):
    x = _gk_inputs()
    assert np.array_equal(
        _bits(jproposal.gk_quantile_candidates(x, k)),
        _bits(proposal.gk_quantile_candidates(x, k)))


@pytest.mark.parametrize("k", [4, 16, 32, 300])
def test_exact_equal_index_for_index(k):
    x, _ = _ties(3000, 4, 6)
    x = np.concatenate([x, _gk_inputs()], axis=1)
    assert np.array_equal(_bits(jproposal.exact_candidates(x, k)),
                          _bits(proposal.exact_candidates(x, k)))


@pytest.mark.parametrize("name", ["gk_quantile_candidates",
                                  "exact_candidates"])
def test_degenerate_features_match(name):
    """tests/test_proposal_binning.py:101's constant and empty columns."""
    for x in (np.full((50, 2), 3.5, dtype=np.float32),
              np.empty((0, 3), dtype=np.float32)):
        want = getattr(jproposal, name)(x, 4)
        got = getattr(proposal, name)(x, 4)
        assert got.shape == want.shape and np.array_equal(want, got)


def test_gk_summary_matches():
    """The copied summary keeps the same tuples and answers."""
    data = np.random.default_rng(2).normal(size=2000).astype(np.float32)
    a, b = jsketch.GKSummary(0.05), sketch.GKSummary(0.05)
    a.extend(data)
    b.extend(data)
    assert (a._v, a._g, a._d) == (b._v, b._g, b._d)
    for phi in (0.1, 0.25, 0.5, 0.75, 0.9):
        assert a.query(phi) == b.query(phi)
    assert len(a) == len(b)
    with pytest.raises(ValueError):
        sketch.GKSummary(1.5)
    with pytest.raises(ValueError, match="empty"):
        sketch.GKSummary(0.1).query(0.5)
    assert sketch.GKSummary(0.1).candidates(4).shape == (0,)


# -- propose -----------------------------------------------------------------

def _x(n=100, f=3, seed=0):
    return torch.from_numpy(np.random.default_rng(seed).normal(
        size=(n, f)).astype(np.float32))


def test_propose_dispatches_to_each_strategy():
    x = _x()
    gen = torch.Generator().manual_seed(1)
    got = proposal.propose("random", x, 5, generator=gen)
    assert torch.equal(got, proposal.random_candidates(
        torch.Generator().manual_seed(1), x, 5))
    h = torch.rand(100)
    assert torch.equal(proposal.propose("weighted_quantile", x, 5, hess=h),
                       proposal.weighted_quantile_candidates(x, h, 5))
    assert torch.equal(proposal.propose("uniform_range", x, 5),
                       proposal.uniform_range_candidates(x, 5))
    for name in ("gk_quantile", "exact"):
        got = proposal.propose(name, x, 5, device="cpu")
        want = getattr(proposal, f"{name}_candidates")(x.numpy(), 5)
        assert got.device.type == "cpu" and np.array_equal(got.numpy(), want)
        # an array works as well as a tensor
        assert torch.equal(proposal.propose(name, x.numpy(), 5,
                                            device="cpu"), got)


def test_propose_weighted_quantile_defaults_hess_to_ones():
    x = _x(80, 2, 3)
    assert torch.equal(proposal.propose("weighted_quantile", x, 4),
                       proposal.propose("weighted_quantile", x, 4,
                                        hess=torch.ones(80)))


def test_propose_rules():
    x = _x()
    with pytest.raises(ValueError, match="needs a torch.Generator"):
        proposal.propose("random", x, 4)
    with pytest.raises(ValueError, match="unknown strategy"):
        proposal.propose("median", x, 4)
    for name in ("gk_quantile", "exact"):
        # the JAX package's refusal, word for word
        with pytest.raises(ValueError, match="host-only") as port:
            proposal.propose(name, x, 3, traced=True)
        assert str(port.value) == (
            f"strategy {name!r} is host-only (numpy) and cannot run under "
            f"jit; propose outside the trace (TRACEABLE="
            f"{jproposal.TRACEABLE})")
    # traced=True changes nothing for the device strategies
    assert torch.equal(proposal.propose("uniform_range", x, 4, traced=True),
                       proposal.propose("uniform_range", x, 4))
    assert proposal.TRACEABLE == jproposal.TRACEABLE


def test_propose_host_strategy_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        proposal.propose("exact", _x(), 4)


def test_propose_traced_alias_warns_and_matches():
    x = _x(50, 2, 2)
    hess = torch.ones(50)
    with pytest.warns(DeprecationWarning, match="propose_traced"):
        old = proposal.propose_traced("weighted_quantile", x, 4, None, hess)
    assert torch.equal(old, proposal.propose("weighted_quantile", x, 4,
                                             hess=hess))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        with pytest.raises(ValueError, match="host-only"):
            proposal.propose_traced("exact", x, 4, None, None)


@pytest.mark.parametrize("strategy", ["random", "weighted_quantile",
                                      "uniform_range", "exact",
                                      "gk_quantile"])
def test_propose_shapes_and_sorted(strategy):
    """tests/test_proposal_binning.py's invariant on the port."""
    x = _x(500, 4, 5)
    c = proposal.propose(strategy, x, 8, generator=torch.Generator(),
                         hess=torch.ones(500), device="cpu")
    assert c.shape == (4, 8) and c.dtype == torch.float32
    assert bool((c[:, 1:] >= c[:, :-1]).all())
