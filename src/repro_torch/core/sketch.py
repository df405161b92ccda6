"""Quantile sketches: the "data faithful" baselines the paper argues against.

Two implementations, as in the JAX package:

* :class:`GKSummary`: a Greenwald-Khanna (SIGMOD'01) streaming summary
  with the (v, g, delta) tuple representation, INSERT and COMPRESS.  It
  is host-side numpy by design (the paper's point is that this machinery
  costs more than random sampling), copied from the JAX package so that
  it answers index for index as that one does.

* :func:`weighted_quantiles`: the XGBoost-style weighted variant, split
  candidates at equal steps of cumulative *hessian* weight, in torch on
  the device of its inputs and batched over features.  Its prefix sum is
  ``ref.blocked_prefix`` (XLA:CPU's association of ``jnp.cumsum``), so the
  candidates are the JAX package's bit for bit.
"""

from __future__ import annotations

import bisect

import numpy as np
import torch

from ..kernels.ref import blocked_prefix


class GKSummary:
    """Greenwald-Khanna eps-approximate quantile summary.

    Maintains tuples (v_i, g_i, delta_i) with sum_{j<=i} g_j - 1 <=
    rmin(v_i) and rmin(v_i) + delta_i = rmax(v_i); the invariant g_i +
    delta_i <= 2 eps n guarantees any rank query is answered within eps n.
    """

    def __init__(self, eps: float):
        if not 0 < eps < 1:
            raise ValueError("eps must be in (0,1)")
        self.eps = eps
        self.n = 0
        # columns: value, g, delta
        self._v: list[float] = []
        self._g: list[int] = []
        self._d: list[int] = []

    def insert(self, value: float) -> None:
        i = bisect.bisect_left(self._v, value)
        if i == 0 or i == len(self._v):
            # new min or max: delta = 0
            self._v.insert(i, value)
            self._g.insert(i, 1)
            self._d.insert(i, 0)
        else:
            delta = int(np.floor(2 * self.eps * self.n)) if self.n else 0
            self._v.insert(i, value)
            self._g.insert(i, 1)
            self._d.insert(i, delta)
        self.n += 1
        # amortised compress
        if self.n % max(1, int(1.0 / (2 * self.eps))) == 0:
            self.compress()

    def extend(self, values) -> None:
        for v in np.asarray(values).ravel():
            self.insert(float(v))

    def compress(self) -> None:
        """Merge adjacent tuples while g_i + g_{i+1} + delta_{i+1} <=
        2 eps n."""
        if len(self._v) < 3:
            return
        cap = int(np.floor(2 * self.eps * self.n))
        v, g, d = self._v, self._g, self._d
        i = len(v) - 2
        while i >= 1:
            if g[i] + g[i + 1] + d[i + 1] <= cap:
                g[i + 1] += g[i]
                del v[i], g[i], d[i]
            i -= 1

    def query(self, phi: float) -> float:
        """Value whose rank is within eps n of ceil(phi n)."""
        if self.n == 0:
            raise ValueError("empty summary")
        target = max(1, int(np.ceil(phi * self.n)))
        bound = self.eps * self.n
        rmin = 0
        for i in range(len(self._v)):
            rmin += self._g[i]
            rmax = rmin + self._d[i]
            if target - rmin <= bound and rmax - target <= bound:
                return self._v[i]
        return self._v[-1]

    def candidates(self, k: int) -> np.ndarray:
        """k split candidates at evenly spaced quantiles (the XGBoost use).

        An empty summary has no quantiles: returns a zero-length array
        (the proposer pads it; ``query`` would raise).
        """
        if self.n == 0:
            return np.empty((0,), dtype=np.float32)
        self.compress()
        phis = (np.arange(1, k + 1)) / (k + 1)
        return np.array(sorted({self.query(p) for p in phis}),
                        dtype=np.float32)

    def __len__(self) -> int:
        return len(self._v)


def gk_candidates(values: np.ndarray, k: int) -> np.ndarray:
    """Build a GK summary over ``values`` and query k candidates.

    eps is 1/k per the paper's Section 3.2 ("we expect to have as many
    bins as 1/eps").  Returns a sorted float32 array of <= k unique
    candidate values.
    """
    sk = GKSummary(eps=1.0 / max(2, k))
    sk.extend(values)
    return sk.candidates(k)


def stable_order(values: torch.Tensor) -> torch.Tensor:
    """``jnp.argsort`` along the last axis: a stable ascending order in
    which -0.0 and +0.0 are equal and every NaN sorts last.

    The card's stable sort (a radix sort) puts a NaN with its sign bit set
    first; every NaN is made the positive NaN before sorting.  Both
    devices' sorts take -0.0 and +0.0 as equal keys.
    """
    keys = torch.where(torch.isnan(values), float("nan"), values)
    return torch.sort(keys, dim=-1, stable=True).indices


def weighted_quantiles(values: torch.Tensor, weights: torch.Tensor,
                       k: int) -> torch.Tensor:
    """XGBoost-style weighted quantile candidates.

    Candidates sit at equal steps of cumulative weight (XGBoost uses the
    hessian as the weight; eq. (8)-(9) of the XGBoost paper).

    Args:
      values: (..., n) feature values, one row per feature.
      weights: (n,) or (..., n) nonnegative weights (e.g. hessians).
      k: number of candidates.

    Returns:
      (..., k) sorted candidate values, on the device of ``values``.
    """
    n = values.shape[-1]
    order = stable_order(values)
    v = torch.gather(values, -1, order)
    w = weights.expand_as(values)
    w = torch.gather(w, -1, order).clamp_min(0.0)
    cw = blocked_prefix(w)
    total = cw[..., -1:]
    # k targets at equal weight steps (excluding 0 and total).  The divisor
    # is a tensor: CUDA divides by a Python scalar as a product with its
    # reciprocal, which rounds some steps 1 ulp away from the quotient
    steps = torch.arange(1, k + 1, dtype=torch.float32,
                         device=values.device)
    steps = steps / torch.full_like(steps, k + 1)
    targets = steps * total
    idx = torch.searchsorted(cw.contiguous(), targets.contiguous(),
                             side="left").clamp(0, n - 1)
    return torch.gather(v, -1, idx)
