"""Per-round training telemetry: the :class:`TrainReport` struct-of-arrays.

``boosting.fit`` emits one :class:`TrainReport` row per boosting round
behind ``GBDTConfig.telemetry``.  The rows are 0-d tensors built on the
training device from what the round already computed (the grad/hess
panel, the tree's :class:`repro_torch.core.tree.TreeStats`, the updated
margin), stacked once after the last round: turning telemetry on adds
no host synchronisation to the round loop and cannot change the forest.

Fields (all shape ``(n_trees,)``, one entry per round), as in the JAX
package:

  train_loss        mean train loss after the round's margin update
                    (logistic: mean log-loss; mse: mean 0.5*(m-y)^2)
  grad_norm         L2 norm of the gradient vector at round start
  hess_norm         L2 norm of the hessian vector at round start
  n_splits          realized (gain > 0) splits in the round's tree
  best_gain_max     largest realized split gain in the tree (0 if none)
  best_gain_mean    mean realized split gain (0 if no splits)
  all_gather_bytes  estimated all_gather payload per worker for the
                    round's candidate proposal (0 on a single host)
  psum_bytes        estimated all-reduce payload per worker for the
                    round's histogram / leaf reductions (0 on a single host)
  hist_updates      MEASURED histogram updates issued for the round's
                    tree (rows added x features, summed over levels).
                    Direct growth pays n*f per level; subtraction growth
                    only the LEFT-routed rows.

The schema string of :meth:`TrainReport.to_json` is the JAX package's
(``repro.obs.TrainReport/v2``), so a report of either package reads the
same.  The distributed byte fields are estimates computed on the host
from static shapes (:func:`collective_bytes_per_round`).
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np
import torch

SCHEMA = "repro.obs.TrainReport/v2"


def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


class TrainReport(NamedTuple):
    """Struct-of-arrays of per-round training scalars (see module doc)."""
    train_loss: torch.Tensor
    grad_norm: torch.Tensor
    hess_norm: torch.Tensor
    n_splits: torch.Tensor
    best_gain_max: torch.Tensor
    best_gain_mean: torch.Tensor
    all_gather_bytes: torch.Tensor
    psum_bytes: torch.Tensor
    hist_updates: torch.Tensor

    @property
    def n_rounds(self) -> int:
        return int(self.train_loss.shape[0])

    def to_dict(self) -> dict:
        """Full per-round record as JSON-ready lists."""
        out = {}
        for name, arr in self._asdict().items():
            a = _np(arr)
            out[name] = [int(v) for v in a] if np.issubdtype(
                a.dtype, np.integer) else [float(v) for v in a]
        return out

    def summarize(self) -> dict:
        """Host-side scalar summary (everything JSON-serialisable)."""
        loss = _np(self.train_loss).astype(np.float64)
        gnorm = _np(self.grad_norm).astype(np.float64)
        splits = _np(self.n_splits)
        gmax = _np(self.best_gain_max).astype(np.float64)
        ag = _np(self.all_gather_bytes).astype(np.float64)
        ps = _np(self.psum_bytes).astype(np.float64)
        upd = _np(self.hist_updates).astype(np.float64)
        return {
            "n_rounds": self.n_rounds,
            "train_loss": {"first": float(loss[0]), "final": float(loss[-1]),
                           "min": float(loss.min())},
            "grad_norm": {"first": float(gnorm[0]), "final": float(gnorm[-1])},
            "splits": {"total": int(splits.sum()),
                       "mean_per_tree": float(splits.mean()),
                       "min": int(splits.min()), "max": int(splits.max())},
            "best_gain": {"max": float(gmax.max()),
                          "final": float(gmax[-1])},
            "collective_bytes": {"all_gather_total": float(ag.sum()),
                                 "psum_total": float(ps.sum()),
                                 "per_round": float((ag + ps).mean())},
            "scatter_updates": {"total": float(upd.sum()),
                                "per_round_mean": float(upd.mean())},
        }

    def to_json(self, path: str | None = None, *, indent: int = 1) -> str:
        """Serialise the full report (+ summary) to JSON; optionally write
        it to ``path``."""
        rec = {"schema": SCHEMA,
               "n_rounds": self.n_rounds,
               "rounds": self.to_dict(),
               "summary": self.summarize()}
        s = json.dumps(rec, indent=indent)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(s)
        return s


def mean_train_loss(margin: torch.Tensor, y: torch.Tensor,
                    objective: str, *, weight: torch.Tensor | None = None,
                    n_global: int | None = None,
                    psum=None) -> torch.Tensor:
    """Mean train loss of ``margin`` against ``y``, a 0-d tensor.

    The logistic loss is ``softplus(m) - y * m`` with softplus as the JAX
    package computes it, ``logaddexp(m, 0)``; ``torch.nn.functional.
    softplus`` returns ``m`` itself above its threshold of 20.

    The distributed trainer's arguments, as in the JAX package: ``weight``
    masks rows out of the sum (padding), ``psum`` sums a tensor over the
    group, and ``n_global`` is the true row count of all the ranks.  By
    default the mean is this process's, over its rows.
    """
    if objective == "logistic":
        per_row = torch.logaddexp(margin, torch.zeros_like(margin)) \
            - y * margin
    elif objective == "mse":
        per_row = 0.5 * (margin - y) ** 2
    else:
        raise ValueError(f"unknown objective {objective!r}")
    if weight is not None:
        per_row = per_row * weight
    total = per_row.sum()
    if psum is not None:
        total = psum(total)
    return total / (margin.shape[0] if n_global is None else n_global)


def round_report(*, margin, y, g, h, objective: str, stats,
                 n_global: int | None = None, weight=None,
                 psum=None) -> TrainReport:
    """Build one round's TrainReport row (all 0-d tensors).

    Args:
      margin: post-update margin (the round's loss is measured after its
        tree is applied).
      g, h: the grad/hess panel the round's tree was built from (already
        masked by ``weight`` in the distributed trainer).
      stats: :class:`repro_torch.core.tree.TreeStats` from ``build_tree``.
      n_global, weight, psum: the distributed trainer's, as in
        :func:`mean_train_loss`; the squared norms and the histogram
        updates are summed over the group too, so every rank holds the
        same row.

    The collective-byte fields are zero here; the distributed trainer
    fills them in from :func:`collective_bytes_per_round`.
    """
    sq_g, sq_h = (g * g).sum(), (h * h).sum()
    upd = stats.hist_updates
    if psum is not None:
        sq_g, sq_h, upd = psum(sq_g), psum(sq_h), psum(upd)
    loss = mean_train_loss(margin, y, objective, weight=weight,
                           n_global=n_global, psum=psum)
    mean_gain = stats.gain_sum / stats.n_splits.to(torch.float32).clamp_min(
        1.0)
    zero = torch.zeros((), dtype=torch.float32, device=margin.device)
    return TrainReport(
        train_loss=loss.to(torch.float32),
        grad_norm=torch.sqrt(sq_g).to(torch.float32),
        hess_norm=torch.sqrt(sq_h).to(torch.float32),
        n_splits=stats.n_splits.to(torch.int32),
        best_gain_max=stats.gain_max.to(torch.float32),
        best_gain_mean=mean_gain.to(torch.float32),
        all_gather_bytes=zero,
        psum_bytes=zero,
        hist_updates=upd.to(torch.float32),
    )


def collective_bytes_per_round(cfg, n_features: int, n_workers: int,
                               *, dtype_bytes: int = 4):
    """Estimated per-worker collective payload, one entry per round.

    Counts the logical payload each worker *receives* per round of a
    distributed fit:

      all_gather: the candidate-proposal gather (Algorithm 1's combine
        step): ``W * f * k`` floats for the pool-resample ('random') and
        quantile-merge strategies; zero for 'uniform_range' (its min/max
        ride the all-reduce).
      psum: the per-level histogram all-reduce (``max_depth * frontier *
        f * nbins * 2`` floats, with ``frontier`` replaced by the
        half-width parent panel ``max(frontier // 2, 1)`` under
        ``cfg.subtract``), the leaf grad/hess reduction
        (``2^max_depth * 2``), the uniform_range min/max (``2 * f``) when
        applicable, and the telemetry scalar reductions (4 floats) when
        telemetry is on.

    With ``repropose_each_round=False`` the proposal collectives only
    happen in round 0.

    This is the JAX package's estimate (``dtype_bytes=4``: float32
    panels), kept for parity.  On the card the port's histogram crosses
    as int64 sums and int32 counts instead (fixed point, see
    ``core/distributed.py``), and on the CPU as an all-gather of every
    rank's panel; ``launch.distributed.collective_bytes`` counts what
    really passes.

    Returns:
      ``(all_gather_bytes, psum_bytes)``: two ``(n_trees,)`` float32
      numpy arrays, ready to splice into a :class:`TrainReport`.
    """
    k = cfg.n_candidates
    nbins = cfg.nbins
    frontier = 2 ** max(cfg.max_depth - 1, 0)

    if cfg.strategy in ("random", "weighted_quantile", "gk_quantile"):
        ag_prop = n_workers * n_features * k * dtype_bytes
        ps_prop = 0
    elif cfg.strategy == "uniform_range":
        ag_prop = 0
        ps_prop = 2 * n_features * dtype_bytes          # min + max
    else:
        ag_prop, ps_prop = 0, 0

    hist_nodes = max(frontier // 2, 1) if cfg.subtract else frontier
    ps_tree = (cfg.max_depth * hist_nodes * n_features * nbins * 2
               + 2 ** cfg.max_depth * 2) * dtype_bytes
    ps_telemetry = 4 * dtype_bytes if cfg.telemetry else 0

    ag = np.zeros(cfg.n_trees, np.float32)
    ps = np.full(cfg.n_trees, ps_tree + ps_telemetry, np.float32)
    prop_rounds = slice(None) if cfg.repropose_each_round else slice(0, 1)
    ag[prop_rounds] += ag_prop
    ps[prop_rounds] += ps_prop
    return ag, ps
