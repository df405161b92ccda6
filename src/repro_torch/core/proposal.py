"""Candidate split-point proposal strategies.

The paper's contribution is the ``random`` strategy (uniform sampling of
feature values) plus its distributed form (Algorithm 1: local sample ->
all-gather -> shared resample).  The baselines it is measured against are
the "data faithful" strategies: the GK quantile summary (XGBoost's
unweighted limit), the weighted quantile sketch (XGBoost proper), and
fixed uniform-range bins (CatBoost-style).

Every strategy returns a dense (f, k) float32 grid, sorted per feature; a
feature with fewer distinct values than k repeats values, which binning
turns into empty bins.  The :data:`TRACEABLE` strategies are torch on the
device of ``x`` and agree with the JAX package's bit for bit
(``weighted_quantile``, ``uniform_range``) or in distribution
(``random``).  The host strategies (``gk_quantile``, ``exact``) are numpy,
copied from the JAX package, index for index.

Random numbers come from an explicit ``torch.Generator`` on the data's
device.  They are not the JAX package's ``jax.random`` draws, so parity
with it is held by injecting the same grid into both (``fit(...,
candidates=...)``).
"""

from __future__ import annotations

import warnings
from typing import Literal

import numpy as np
import torch

from . import sketch
from ..kernels.ops import device_of

Strategy = Literal["random", "gk_quantile", "weighted_quantile",
                   "uniform_range", "exact"]

# Strategies that run on the device and that the trainers re-propose
# every round; the host strategies ('gk_quantile', 'exact') are x-only,
# their candidates identical every round, so a fit proposes them once.
TRACEABLE: tuple[str, ...] = ("random", "weighted_quantile",
                              "uniform_range")


# ---------------------------------------------------------------------------
# The paper's method: uniform random sampling (O(n) per feature).
# ---------------------------------------------------------------------------

def random_candidates(generator: torch.Generator, x: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Uniform random candidates for every feature.

    Args:
      generator: a ``torch.Generator`` on ``x``'s device.
      x: (n, f) feature matrix.
      k: candidates per feature.

    Returns:
      (f, k) candidates, sorted per feature: each a value of its own
      column at a row drawn uniformly (with replacement).
    """
    n, f = x.shape
    idx = torch.randint(0, n, (f, k), generator=generator, device=x.device)
    return torch.gather(x.T, 1, idx).sort(dim=1).values


def random_candidates_local(generator: torch.Generator,
                            x_local: torch.Tensor, k: int) -> torch.Tensor:
    """Per-worker local sampling done 'during data read' (Appendix 6.1)."""
    return random_candidates(generator, x_local, k)


def resample_gathered(generator: torch.Generator, gathered: torch.Tensor,
                      k: int) -> torch.Tensor:
    """Algorithm 1's step after the all-gather: pool, then resample to k.

    Args:
      generator: seeded alike on every worker, so each computes the same
        grid without a second broadcast.
      gathered: (workers, f, kk) candidates from every worker.
      k: target candidates per feature.

    Returns:
      (f, k) sorted candidates.
    """
    w, f, kk = gathered.shape
    pool = gathered.permute(1, 0, 2).reshape(f, w * kk)
    idx = torch.randint(0, w * kk, (f, k), generator=generator,
                        device=gathered.device)
    return torch.gather(pool, 1, idx).sort(dim=1).values


# ---------------------------------------------------------------------------
# Baselines ("data faithful").
# ---------------------------------------------------------------------------

def _pad_candidates(c: np.ndarray, k: int) -> np.ndarray:
    """Right-pad a (possibly empty) candidate row to length k.

    Degenerate features (constant columns, empty inputs) can yield zero
    candidates, where ``np.pad(..., mode='edge')`` raises; an all-zero row
    is harmless (binning collapses duplicate candidates into empty bins,
    so the feature is simply never split on).
    """
    c = np.asarray(c, dtype=np.float32)
    if len(c) >= k:
        return c[:k]
    if len(c) == 0:
        return np.zeros(k, dtype=np.float32)
    return np.pad(c, (0, k - len(c)), mode="edge")


def gk_quantile_candidates(x: np.ndarray, k: int) -> np.ndarray:
    """GK-summary candidates per feature (host-side; deliberately costly)."""
    x = np.asarray(x)
    out = np.empty((x.shape[1], k), dtype=np.float32)
    for j in range(x.shape[1]):
        out[j] = _pad_candidates(sketch.gk_candidates(x[:, j], k), k)
    return out


def weighted_quantile_candidates(x: torch.Tensor, hess: torch.Tensor,
                                 k: int) -> torch.Tensor:
    """XGBoost weighted-quantile candidates, hessian-weighted: (f, k)."""
    return sketch.weighted_quantiles(x.T, hess, k)


def _fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 ``a + b * c`` rounded once, as a fused multiply-add.

    The product of two float32 values is exact in float64.  The float64
    sum is made round-to-odd (its TwoSum error decides the last bit of an
    inexact sum), and a round-to-odd value with 29 bits to spare rounds
    to float32 as the exact sum would.
    """
    a64, p = a.double(), b.double() * c.double()
    s = a64 + p
    bb = s - a64
    err = (a64 - (s - bb)) + (p - bb)
    even = (s.view(torch.int64) & 1) == 0
    inexact = (err != 0) & even & torch.isfinite(s)
    return torch.where(inexact, torch.nextafter(s, s + err), s).float()


def uniform_range_candidates(x: torch.Tensor, k: int) -> torch.Tensor:
    """CatBoost-style fixed bins: k evenly spaced points in [min, max].

    XLA:CPU forms ``t`` as ``arange * float32(1/(k+1))`` and contracts
    ``lo + (hi - lo) * t`` into one fused multiply-add; both are written
    out, so the grid is the JAX package's bit for bit.
    """
    return uniform_grid(x.amin(dim=0), x.amax(dim=0), k)


def uniform_grid(lo: torch.Tensor, hi: torch.Tensor, k: int) -> torch.Tensor:
    """(f, k): k evenly spaced points strictly inside each ``[lo, hi]``
    (f,), as :func:`uniform_range_candidates` forms them."""
    t = torch.arange(1, k + 1, dtype=torch.float32, device=lo.device) \
        * torch.tensor(1.0 / (k + 1), dtype=torch.float32)
    return _fma32(lo[:, None], (hi - lo)[:, None], t[None, :])


def exact_candidates(x: np.ndarray, k: int) -> np.ndarray:
    """All unique values, capped at k per feature (greedy exact baseline).

    With k >= number of unique values this reproduces the exact greedy
    algorithm; used for correctness tests on small data.
    """
    x = np.asarray(x)
    out = np.empty((x.shape[1], k), dtype=np.float32)
    for j in range(x.shape[1]):
        u = np.unique(x[:, j]).astype(np.float32)
        if len(u) >= k:
            idx = np.linspace(0, len(u) - 1, k).round().astype(int)
            out[j] = u[idx]
        else:
            out[j] = _pad_candidates(u, k)
    return out


# ---------------------------------------------------------------------------
# Unified front end.
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def propose(strategy: Strategy, x, k: int, *,
            generator: torch.Generator | None = None,
            hess: torch.Tensor | None = None, traced: bool | None = None,
            device="cuda") -> torch.Tensor:
    """Unified proposal dispatch (the JAX package's ``propose``).

    The :data:`TRACEABLE` strategies run on the device of ``x``.  The host
    strategies ('gk_quantile', 'exact') run numpy on a host copy of ``x``
    and return their grid on ``device``.  The port traces nothing, so
    ``traced=None`` means the host path; ``traced=True`` keeps the JAX
    package's rule and refuses the host strategies with its message.

    Args:
      x: (n, f) feature matrix (tensor, or array for the host strategies).
      k: candidates per feature.
      generator: a ``torch.Generator`` on ``x``'s device (required for
        'random').
      hess: (n,) hessian weights for 'weighted_quantile'; defaults to
        ones (the unweighted quantile sketch).
      device: where the host strategies put their grid; 'cuda' (the
        default) raises without a GPU.

    Returns:
      (f, k) sorted float32 candidates.
    """
    if strategy in TRACEABLE:
        x = torch.as_tensor(x)
    if strategy == "random":
        if generator is None:
            raise ValueError("random proposal needs a torch.Generator")
        return random_candidates(generator, x, k)
    if strategy == "weighted_quantile":
        if hess is None:
            hess = torch.ones(x.shape[0], dtype=torch.float32,
                              device=x.device)
        return weighted_quantile_candidates(x, hess, k)
    if strategy == "uniform_range":
        return uniform_range_candidates(x, k)
    if strategy not in ("gk_quantile", "exact"):
        raise ValueError(f"unknown strategy {strategy!r}")
    if traced:
        raise ValueError(
            f"strategy {strategy!r} is host-only (numpy) and cannot run "
            f"under jit; propose outside the trace (TRACEABLE={TRACEABLE})")
    fn = gk_quantile_candidates if strategy == "gk_quantile" \
        else exact_candidates
    return torch.from_numpy(fn(_host(x), k)).to(device_of(device))


def propose_traced(strategy: Strategy, x: torch.Tensor, k: int,
                   generator: torch.Generator | None,
                   hess: torch.Tensor | None) -> torch.Tensor:
    """Deprecated: use ``propose(strategy, x, k, generator=generator,
    hess=hess)``."""
    warnings.warn(
        "propose_traced is deprecated; use propose(strategy, x, k, "
        "generator=generator, hess=hess)", DeprecationWarning, stacklevel=2)
    return propose(strategy, x, k, generator=generator, hess=hess,
                   traced=True)
