"""Distributed GBDT training: the paper's Algorithm 1 on ``torch.distributed``.

The JAX package's ``repro.core.distributed`` maps the paper's
Rabit/AllReduce world onto a mesh; here it maps onto a process group:

  * worker -> one rank.  Every rank calls :func:`fit_distributed` with the
    whole data, as the JAX driver takes it, and keeps its slice of rows.
  * local sample at data read -> ``random_candidates_local`` on the rank's
    rows, from the rank's own generator (the counterpart of
    ``fold_in(key, worker)``).
  * AllReduce (combine + resample) -> an all-gather of the pools in rank
    order, then a resample from a generator seeded alike on every rank,
    so every rank computes the same grid with no broadcast.
  * histogram AllReduce -> the panels summed over the group inside
    ``build_tree`` (:class:`TreeReduce`); with ``cfg.subtract`` only the
    half panels of the left children cross.

How a sum crosses decides the bits.  On the CPU each rank's float32 panel
(and leaf sums, and telemetry scalars) is gathered and added in rank
order, ``((p0 + p1) + p2) + ...``, which is what XLA:CPU's ``psum`` does:
a distributed tree is the JAX package's bit for bit.  On the card the
histogram kernel sums in fixed point, and its shift depends on the rows
it sees; so every rank takes one shared grid (the largest |g| and |h|
over all ranks, by an all-reduce MAX of their float bits, and ``N =
ceil(log2 n)`` of all the unpadded rows), its int64 sums and int32 counts
are all-reduced (integer adds, exact in any order) and rounded once.  The
panels and leaf sums are then those of one launch over all the rows, and
a fit on the card gives the same bits at every world size.

When ``n`` does not divide by the world size the data is padded with
repeats of the leading rows, with validity weight 0: a pad row's g and h
are zeroed every round and it drops out of the base score and the loss
(``n_global`` is the true row count), so the padded fit computes the
statistics of the unpadded data.

``reference=True`` is the JAX package's unrolled oracle worker: the same
loop with each round's margin updated by descending its tree over the
bins instead of by the leaf ids growth returns.  It builds no report.
"""

from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from . import binning, proposal, sketch, tree as tree_lib
from .boosting import GBDTConfig, GBDTModel, grad_hess
from ..kernels import ops, ref
from ..kernels.ops import device_of
from ..launch.distributed import all_gather, all_reduce, sum_in_rank_order
from ..obs.report import TrainReport, collective_bytes_per_round, \
    round_report

# strategies with a distributed form ('exact' has none, as in the JAX
# package; 'gk_quantile' is the weighted quantile by validity there)
STRATEGIES = ("random", "weighted_quantile", "gk_quantile", "uniform_range")


def merge_quantile_gathered(gathered: torch.Tensor, k: int) -> torch.Tensor:
    """Distributed sketch merge: sort the union, take k evenly spaced.

    ``gathered`` (workers, f, kk) -> (f, k).  The positions are those of
    the JAX function under ``jit``, index for index: XLA:CPU folds
    ``(arange / (k+1)) * (w * kk)`` into ``arange * c`` with ``c`` the
    float32 product of ``float32(1/(k+1))`` and ``w * kk``.
    """
    w, f, kk = gathered.shape
    pool = gathered.permute(1, 0, 2).reshape(f, w * kk)
    pool = torch.gather(pool, 1, sketch.stable_order(pool))
    c = np.float32(np.float32(1.0 / (k + 1)) * np.float32(w * kk))
    idx = torch.floor(torch.arange(1, k + 1, dtype=torch.float32,
                                   device=gathered.device)
                      * torch.tensor(c, device=gathered.device))
    return pool[:, idx.long()]


def shared_max_bits(gh: torch.Tensor, group=None) -> torch.Tensor:
    """(2,) int32 ``ref.max_bits`` over the rows of every rank."""
    return all_reduce(ref.max_bits(gh), dist.ReduceOp.MAX, group)


def fixed_point_hist(bins: torch.Tensor, node_per_level: torch.Tensor,
                     gh: torch.Tensor, spec: ops.HistSpec, *,
                     bits: torch.Tensor, log2n: int, group=None):
    """:func:`ops.hist_levels` summed over the group in fixed point on the
    shared grid (``bits``, ``log2n``): each rank's int64 sums (and, in
    child mode, int32 counts) are all-reduced, then rounded once.  The
    result is ``ref.hist_levels_fixed`` over every rank's rows."""
    out = ops.hist_levels_raw(bins, node_per_level, gh, spec, bits=bits,
                              log2n=log2n)
    total, cnt = out if spec.subtract else (out, None)
    panel = ref.from_fixed(all_reduce(total, group=group), bits, log2n)
    if cnt is None:
        return panel
    return panel, all_reduce(cnt, group=group)


def fixed_point_leaf_sums(node: torch.Tensor, gh: torch.Tensor,
                          n_leaves: int, *, bits: torch.Tensor, log2n: int,
                          group=None) -> torch.Tensor:
    """``ref.fixed_point_sums`` over every rank's rows, on the shared
    grid: int64 sums all-reduced, then rounded once."""
    total = ref.fixed_point_sums(node, gh, n_leaves, bits=bits, log2n=log2n,
                                 raw=True)
    return ref.from_fixed(all_reduce(total, group=group), bits, log2n)


class TreeReduce:
    """The group's reductions for one tree, grown from ``gh``: drop-in
    ``hist_levels`` and ``leaf_sums`` for ``build_tree(reduce=...)``.

    On the card the grid is shared (:func:`shared_max_bits` once a tree,
    ``N`` of the ``n_global`` rows) and the sums are fixed point
    (:func:`fixed_point_hist`, :func:`fixed_point_leaf_sums`).  On the CPU
    the float32 panels and leaf sums are added in rank order and the row
    counts all-reduced.
    """

    def __init__(self, gh: torch.Tensor, *, n_global: int, group=None):
        self.group = group
        self.on_card = gh.device.type == "cuda"
        if self.on_card:
            self.bits = shared_max_bits(gh, group)
            self.log2n = ref.log2_ceil(n_global)

    def hist_levels(self, bins, node_per_level, gh, spec):
        if self.on_card:
            return fixed_point_hist(bins, node_per_level, gh, spec,
                                    bits=self.bits, log2n=self.log2n,
                                    group=self.group)
        out = ops.hist_levels(bins, node_per_level, gh, spec)
        if spec.subtract:
            return (sum_in_rank_order(out[0], self.group),
                    all_reduce(out[1], group=self.group))
        return sum_in_rank_order(out, self.group)

    def leaf_sums(self, node, gh, n_leaves, backend="auto"):
        if self.on_card:
            return fixed_point_leaf_sums(node, gh, n_leaves, bits=self.bits,
                                         log2n=self.log2n, group=self.group)
        return sum_in_rank_order(ops.leaf_sums(node, gh, n_leaves, backend),
                                 self.group)


def _worker_propose(cfg: GBDTConfig, shared: torch.Generator, x_local, hess,
                    w_local, local_pool, group) -> torch.Tensor:
    """One round's distributed proposal.  ``hess`` is already masked for
    pad rows; ``w_local`` is the validity weight (the unweighted quantile
    uses it, so pad rows carry no rank mass)."""
    if cfg.strategy == "random":
        gathered = torch.stack(all_gather(local_pool, group))   # (W, f, k)
        return proposal.resample_gathered(shared, gathered, cfg.n_candidates)
    if cfg.strategy in ("weighted_quantile", "gk_quantile"):
        local_c = proposal.weighted_quantile_candidates(
            x_local, hess if cfg.strategy == "weighted_quantile" else w_local,
            cfg.n_candidates)
        gathered = torch.stack(all_gather(local_c, group))
        return merge_quantile_gathered(gathered, cfg.n_candidates)
    if cfg.strategy == "uniform_range":
        lo = all_reduce(x_local.amin(dim=0), dist.ReduceOp.MIN, group)
        hi = all_reduce(x_local.amax(dim=0), dist.ReduceOp.MAX, group)
        return proposal.uniform_grid(lo, hi, cfg.n_candidates)
    raise ValueError(f"strategy {cfg.strategy!r} has no distributed form")


def _masked_grad_hess(margin, y_local, w_local, objective: str):
    """Per-row loss stats with pad rows zeroed: a weight-0 row adds
    nothing to a histogram, a leaf or any reduction."""
    g, h = grad_hess(margin, y_local, objective)
    return g * w_local, h * w_local


def _base_score(y_local, w_local, *, n_global: int, objective: str, group):
    """The global base score from the pad-free label sum, in float32.

    The JAX worker's ``ysum / n_global`` compiles on XLA:CPU to a product
    with ``float32(1/n_global)``; so is it here (the single-host ``fit``
    forms its mean the same way).
    """
    ysum = sum_in_rank_order((y_local * w_local).sum(), group)
    mean = ysum * torch.tensor(np.float32(1.0 / n_global),
                               device=ysum.device)
    if objective == "logistic":
        p = mean.clamp(1e-6, 1 - 1e-6)
        return torch.log(p / (1 - p))
    return mean


def _derived_seed(seed: int, *ids: int) -> int:
    return int(np.random.SeedSequence([seed, *ids]).generate_state(
        1, np.uint64)[0] >> 1)


def fit_distributed(x, y, cfg: GBDTConfig, *, group=None, seed: int = 0,
                    candidates=None, reference: bool = False,
                    device="cuda") -> GBDTModel:
    """Train a GBDT with the rows sharded over the ranks of ``group``.

    Every rank of ``group`` (the default group when None) calls this with
    the same arguments; each trains on its slice of rows and all return
    the same model.  Semantics match :func:`repro_torch.fit` up to the
    candidate grids (each rank samples locally, then the union is
    resampled: Algorithm 1).

    Args:
      x, y: the WHOLE data, (n, f) and (n,) (arrays or tensors), moved to
        ``device`` as float32.  Padded with repeats of the leading rows
        (weight 0) to a multiple of the world size.
      cfg: the config; ``cfg.strategy`` one of :data:`STRATEGIES`.  With
        ``cfg.telemetry`` the model carries a :class:`TrainReport`, the
        same on every rank, its byte fields from
        :func:`repro_torch.obs.collective_bytes_per_round`.
      seed: seeds two generators: one shared by every rank, for the
        random strategy's resample, and one per rank for its local pool.
      candidates: an injected grid, in the convention of
        :attr:`GBDTModel.candidates`: (n_trees, f, k) when the config
        re-proposes each round, else (1, f, k).  The RNG streams of the
        two packages differ, so parity with the JAX package feeds its
        model's candidates here.
      reference: run the unrolled oracle loop (no report).
      device: where this rank trains; 'cuda' (the default) raises without
        a GPU.

    Returns:
      The model on ``device``; ``fit_seconds`` is this rank's.
    """
    if cfg.strategy not in STRATEGIES:
        raise ValueError(f"strategy {cfg.strategy!r} has no distributed "
                         f"form")
    device = device_of(device)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    y = torch.as_tensor(y, device=device).to(torch.float32)
    n_true, f = x.shape
    rounds = cfg.n_trees if cfg.repropose_each_round else 1
    if candidates is not None:
        candidates = torch.as_tensor(candidates, device=device).to(
            torch.float32)
        want = (rounds, f, cfg.n_candidates)
        if tuple(candidates.shape) != want:
            raise ValueError(f"candidates must have shape {want} "
                             f"(repropose_each_round="
                             f"{cfg.repropose_each_round}), got "
                             f"{tuple(candidates.shape)}")
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    t_fit0 = time.perf_counter()
    valid = torch.ones((n_true,), dtype=torch.float32, device=device)
    pad = -n_true % world
    if pad:
        # repeats of the leading rows keep the slices equal; their weight
        # is zero, so they never reach a reduced statistic
        x = torch.cat([x, x[:pad]])
        y = torch.cat([y, y[:pad]])
        valid = torch.cat([valid, torch.zeros((pad,), device=device)])
    per = x.shape[0] // world
    rows = slice(rank * per, (rank + 1) * per)
    x_local, y_local, w_local = x[rows], y[rows], valid[rows]
    del x, y, valid

    telemetry = cfg.telemetry and not reference
    base = _base_score(y_local, w_local, n_global=n_true,
                       objective=cfg.objective, group=group)
    shared = local_pool = None
    if candidates is None and cfg.strategy == "random":
        shared = torch.Generator(device=device).manual_seed(
            _derived_seed(seed, 0))
        local = torch.Generator(device=device).manual_seed(
            _derived_seed(seed, 1, rank))
        # 'data read': the rank's pool (pad rows may be drawn: they repeat
        # real rows, so the pool holds observed values only)
        local_pool = proposal.random_candidates_local(local, x_local,
                                                      cfg.n_candidates)

    margin = torch.full((per,), float(base), dtype=torch.float32,
                        device=device)
    spec = cfg.hist_spec()
    psum = lambda t: sum_in_rank_order(t, group)               # noqa: E731
    trees, cands, reports = [], [], []
    for r in range(cfg.n_trees):
        g, h = _masked_grad_hess(margin, y_local, w_local, cfg.objective)
        if r < rounds:
            c = (candidates[r] if candidates is not None else
                 _worker_propose(cfg, shared, x_local, h, w_local,
                                 local_pool, group))
            bins = binning.bin_features(x_local, c)
            cands.append(c)
        gh = torch.stack([g, h], 1)
        built = tree_lib.build_tree(
            bins, gh, cands[-1], max_depth=cfg.max_depth, spec=spec,
            l2=cfg.l2, gamma=cfg.gamma, min_child_weight=cfg.min_child_weight,
            return_leaf_nodes=True, return_stats=telemetry,
            reduce=TreeReduce(gh, n_global=n_true, group=group))
        t = built[0]
        if reference:
            step = tree_lib.predict_binned(t, bins, max_depth=cfg.max_depth)
        else:   # growth already routed every row to its leaf
            step = t.leaf_value[built[1].long()]
        margin = margin + cfg.learning_rate * step
        if telemetry:
            reports.append(round_report(
                margin=margin, y=y_local, g=g, h=h, objective=cfg.objective,
                stats=built[2], n_global=n_true, weight=w_local, psum=psum))
        trees.append(t)

    report = None
    if telemetry:
        report = TrainReport(*(torch.stack(a) for a in zip(*reports)))
        ag, ps = collective_bytes_per_round(cfg, f, world)
        report = report._replace(
            all_gather_bytes=torch.as_tensor(ag, device=device),
            psum_bytes=torch.as_tensor(ps, device=device))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return GBDTModel(cfg, tree_lib.forest_from_trees(trees), float(base),
                     torch.stack(cands), fit_seconds=time.perf_counter()
                     - t_fit0, report=report)
