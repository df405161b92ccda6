"""Candidate split-point proposal: the paper's random strategy.

``random`` samples k feature values uniformly per feature (the paper's
contribution); :func:`resample_gathered` is the shared-seed resample of
its distributed form (Algorithm 1).  Candidates are a dense (f, k)
float32 grid, sorted per feature; a feature with fewer distinct values
than k repeats values, which binning turns into empty bins.

Random numbers come from an explicit ``torch.Generator`` on the data's
device.  They are not the JAX package's ``jax.random`` draws, so parity
with it is held by injecting the same grid into both (``fit(...,
candidates=...)``).  The other strategies and the ``propose``
dispatcher are not ported yet.
"""

from __future__ import annotations

from typing import Literal

import torch

Strategy = Literal["random", "gk_quantile", "weighted_quantile",
                   "uniform_range", "exact"]

# Strategies the JAX package re-proposes inside its compiled round step
# (the others are x-only and proposed once per fit).
TRACEABLE: tuple[str, ...] = ("random", "weighted_quantile",
                              "uniform_range")


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
