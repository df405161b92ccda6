"""Theorem 1 machinery: expected rank error of candidate-split subsets.

The paper's central theoretical object: given ``n`` sorted feature values
and an (unknown) tree objective ``f`` over split positions, a candidate
subset ``S`` of size ``k`` incurs *rank error*

    R(S, X) = rank (under f) of the best element of S,

so R = 0 when S contains the argmax of f.  Theorem 1: for S uniform
without replacement, ``E[R] = (n - k) / (k + 1)``; normalised by the worst
case (n - k) this is ``1 / (k + 1)``.

This module holds the closed forms, Monte-Carlo estimators for random
subsets (batched over trials on the device) and deterministic binning,
and the machinery behind Fig. 2 of the paper.  Its random draws come from
explicit ``torch.Generator`` s; they are not the JAX package's streams.
Entry points run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels.ops import device_of
from .sketch import stable_order


def expected_rank_error(n: int, k: int) -> float:
    """Closed form of Theorem 1: E[R] = (n - k) / (k + 1)."""
    if not 0 < k <= n:
        raise ValueError(f"need 0 < k <= n, got n={n} k={k}")
    return (n - k) / (k + 1)


def normalized_rank_error(n: int, k: int) -> float:
    """Eq. (6): E = E[R] / (n - k) = 1 / (k + 1)."""
    if k >= n:
        return 0.0
    return expected_rank_error(n, k) / (n - k)


def _ranks(f_values: torch.Tensor) -> torch.Tensor:
    """(..., n) 0-based rank of each position under descending f; equal
    values rank by position (``jnp.argsort(-f)``, stable)."""
    order = stable_order(-f_values)
    ranks = torch.empty_like(order)
    ranks.scatter_(-1, order, torch.arange(
        f_values.shape[-1], device=f_values.device).expand_as(order))
    return ranks


def rank_error_of_subset(f_values: torch.Tensor,
                         subset_idx: torch.Tensor) -> torch.Tensor:
    """Rank error R(S, X) for one subset.

    Args:
      f_values: (n,) objective value at every split position.
      subset_idx: (k,) integer indices into ``f_values`` forming S.

    Returns:
      0-d int64 tensor: the 0-based rank (under descending f) of the best
      element of S (the first of equal bests).  0 means S contains the
      global argmax.
    """
    subset_idx = subset_idx.long()
    best_in_s = subset_idx[torch.argmax(f_values[subset_idx])]
    return _ranks(f_values)[best_in_s]


def _mc_rank_errors(generator: torch.Generator, f_values: torch.Tensor,
                    k: int, trials: int) -> torch.Tensor:
    """(B,) mean rank error of ``trials`` uniform random k-subsets (without
    replacement) of each row of ``f_values`` (B, n), all in one batch."""
    b, n = f_values.shape
    keys = torch.rand((b, trials, n), generator=generator,
                      device=f_values.device)
    subsets = keys.argsort(dim=-1)[..., :k]                 # (B, trials, k)
    rows = f_values[:, None, :].expand(b, trials, n)
    best = torch.gather(subsets, -1, torch.gather(rows, -1, subsets)
                        .argmax(dim=-1, keepdim=True))      # (B, trials, 1)
    ranks = _ranks(f_values)[:, None, :].expand(b, trials, n)
    return torch.gather(ranks, -1, best)[..., 0].to(torch.float32).mean(-1)


def mc_rank_error_random(generator: torch.Generator, f_values: torch.Tensor,
                         k: int, trials: int = 256) -> torch.Tensor:
    """Monte-Carlo E[R] for uniform random subsets of size k: a 0-d
    float32 tensor on the device of ``f_values`` (and of ``generator``)."""
    return _mc_rank_errors(generator, f_values[None], k, trials)[0]


def rank_error_of_binning(f_values: np.ndarray,
                          bin_edges_idx: np.ndarray) -> int:
    """Rank error when S = bin representatives (deterministic binning).

    ``bin_edges_idx`` are the indices (into the sorted data) chosen as the
    bin representatives by a quantile-sketch strategy.
    """
    f = np.asarray(f_values)
    order = np.argsort(-f)
    ranks = np.empty_like(order)
    ranks[order] = np.arange(len(f))
    best = bin_edges_idx[np.argmax(f[bin_edges_idx])]
    return int(ranks[best])


def _sinusoids(freqs: torch.Tensor, phases: torch.Tensor,
               amps: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) sum of sinusoids ``amps * sin(2 pi freqs t + phases)`` over
    ``t = linspace(0, 1, n)``, for (..., roughness) parameters."""
    t = torch.linspace(0.0, 1.0, n, device=freqs.device)
    arg = 2 * torch.pi * freqs[..., None] * t + phases[..., None]
    return (amps[..., None] * torch.sin(arg)).sum(dim=-2)


def _draw_objectives(generator: torch.Generator, shape: tuple, n: int,
                     roughness: int, device) -> torch.Tensor:
    def uniform(lo, hi):
        return lo + (hi - lo) * torch.rand(
            (*shape, roughness), generator=generator, device=device)
    freqs = uniform(0.5, 6.0)
    phases = uniform(0.0, 2 * np.pi)
    amps = uniform(0.2, 1.0)
    return _sinusoids(freqs, phases, amps, n)


def smooth_random_objective(generator: torch.Generator, n: int,
                            roughness: int = 8) -> torch.Tensor:
    """A random smooth objective over split positions (as in Fig. 2), on
    the generator's device.

    Sum of a few random sinusoids: smooth enough that quantile binning
    *could* help if data-faithfulness helped, rough enough to have a
    non-trivial argmax.
    """
    return _draw_objectives(generator, (), n, roughness, generator.device)


def _seed(*words: int) -> int:
    """A 64-bit seed from integers (the role of ``jax.random.fold_in``)."""
    return int(np.random.SeedSequence(list(words)).generate_state(
        1, np.uint64)[0])


def fig2_experiment(seed: int, n: int, ks: list[int], trials: int = 64, *,
                    device="cuda") -> dict:
    """Reproduce Fig. 2: mean normalised rank error vs k.

    For each subset size k, compare (a) uniform random selection with
    (b) deterministic equi-rank binning (the unweighted GK limit: bin
    representatives at every n/k-th rank) on ``trials`` random smooth
    objectives, each scored by 8 random subsets as in the JAX package.
    A size's objectives and subsets are drawn on ``device`` in one batch,
    from a generator seeded by (seed, k).

    Returns dict with 'k', 'random', 'quantile', 'theory' lists of the
    normalised error E = E[R]/(n-k).
    """
    device = device_of(device)
    out = {"k": list(ks), "random": [], "quantile": [], "theory": []}
    for k in ks:
        gen = torch.Generator(device=device).manual_seed(_seed(seed, k))
        f = _draw_objectives(gen, (trials,), n, 8, device)
        rand_errs = _mc_rank_errors(gen, f, k, trials=8)
        # Deterministic equi-rank bins: representative = right edge of
        # each of the k equal-population buckets (the epsilon-approx
        # quantile answer for uniformly weighted data).
        reps = np.floor((np.arange(1, k + 1) * n) / k).astype(int) - 1
        quant_errs = [rank_error_of_binning(row, reps)
                      for row in f.cpu().numpy()]
        out["random"].append(float(rand_errs.mean()) / (n - k))
        out["quantile"].append(float(np.mean(quant_errs)) / (n - k))
        out["theory"].append(normalized_rank_error(n, k))
    return out
