"""Bucketising features against a shared candidate grid.

Convention (as in the JAX package):

  bin_id(x, c) = #{ c_i < x }  = searchsorted(c, x, side='left')

A split at candidate index s sends a row LEFT iff bin_id <= s,
equivalently x <= c_s on raw values.  nbins = k + 1.
"""

from __future__ import annotations

import torch

# Above this many candidates the O(n*f*k) dense comparison gives way to
# the O(n*f*log k) search (the JAX package's threshold, kept so both
# packages take the same regime for the same k).
_DENSE_K_MAX = 64


def bin_features(x: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """Map raw features to bin ids.

    For k <= 64 this counts ``sum_i [c_i < x]`` with one dense broadcast
    comparison; above, it searches each feature's sorted candidates with
    ``torch.searchsorted(side='left')``.  Both count the candidates
    strictly below x, ties included.  NaN rows go to the LAST bin (k) on
    both paths, set explicitly.

    Args:
      x: (n, f) raw float32 features.
      candidates: (f, k) sorted candidate values on the device of ``x``.

    Returns:
      (n, f) int32 bin ids in [0, k].
    """
    k = candidates.shape[1]
    if k <= _DENSE_K_MAX:
        bins = (x[:, :, None] > candidates[None, :, :]).sum(dim=2)
    else:
        bins = torch.searchsorted(candidates.contiguous(), x.T.contiguous(),
                                  side="left").T
    return torch.where(torch.isnan(x), k, bins).to(torch.int32)


def bin_counts(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """Rows per (feature, bin): (f, nbins) int32 (diagnostics, load
    stats).  A bin id outside [0, nbins) is counted nowhere, as the JAX
    package's one-hot count has it."""
    f = bins.shape[1]
    b = bins.long()
    flat = torch.arange(f, device=bins.device)[None, :] * nbins + b
    valid = (b >= 0) & (b < nbins)
    return torch.bincount(flat[valid], minlength=f * nbins).reshape(
        f, nbins).to(torch.int32)
