"""Stacked decision trees and their per-tree predictors.

Heap layout (0-based): inner node i has children 2i+1 / 2i+2; level d
occupies indices [2^d - 1, 2^(d+1) - 2]; leaves are the 2^max_depth
level-(max_depth) nodes.  A passthrough node has feature -1, threshold
+inf and split bin nbins-1: every row goes LEFT.

Split semantics (as in the JAX package):
  row goes left  <=>  bin_id <= split_bin  <=>  x <= threshold
where threshold = candidates[feature, split_bin].

Growth (:func:`build_tree`) is the JAX package's: a complete tree of
static depth over a uniform frontier of ``2^(max_depth-1)`` nodes, one
histogram and one split-gain call per level.  A node that should not
split becomes a passthrough.  The per-tree descent here is the oracle of
the batched engine in :mod:`repro_torch.core.predict`.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..kernels import ops
from ..kernels.ops import HistSpec
from ..kernels.ref import argmax_nan_first, gather_feature


class Tree(NamedTuple):
    """A single fitted tree (all tensors static-shaped)."""
    feature: torch.Tensor     # (2^depth - 1,) int32; -1 = passthrough
    split_bin: torch.Tensor   # (2^depth - 1,) int32; nbins-1 for passthrough
    threshold: torch.Tensor   # (2^depth - 1,) float32; +inf for passthrough
    leaf_value: torch.Tensor  # (2^depth,) float32


class TreeStats(NamedTuple):
    """Per-tree growth telemetry (0-d tensors), from the same gain panels
    the splits come from, so adding it cannot change the tree."""
    n_splits: torch.Tensor      # () int32: realized (gain > 0) splits
    gain_sum: torch.Tensor      # () float32: sum of realized split gains
    gain_max: torch.Tensor      # () float32: largest realized gain (0 if none)
    hist_updates: torch.Tensor  # () float32: histogram updates issued,
    #                             summed over levels as (rows added) * f;
    #                             direct growth adds every row at every
    #                             level, subtraction growth only the rows
    #                             routed LEFT (exact below 2^24 a tree)


class Forest(NamedTuple):
    """A boosted ensemble as a struct-of-arrays: every field of Tree
    stacked along a leading round axis."""
    feature: torch.Tensor     # (T, 2^depth - 1) int32
    split_bin: torch.Tensor   # (T, 2^depth - 1) int32
    threshold: torch.Tensor   # (T, 2^depth - 1) float32
    leaf_value: torch.Tensor  # (T, 2^depth) float32

    @property
    def n_trees(self) -> int:
        return self.feature.shape[0]


def forest_from_trees(trees: list[Tree]) -> Forest:
    """Stack a list of trees."""
    return Forest(*(torch.stack(a) for a in zip(*trees)))


def forest_trees(forest: Forest) -> list[Tree]:
    """Per-tree views of a forest."""
    return [Tree(*(a[i] for a in forest)) for i in range(forest.n_trees)]


def _descend(feature: torch.Tensor, cmp: torch.Tensor,
             leaf_value: torch.Tensor, values: torch.Tensor,
             max_depth: int) -> torch.Tensor:
    node = torch.zeros((values.shape[0],), dtype=torch.long,
                       device=values.device)     # level-local id
    for depth in range(max_depth):
        heap = (2 ** depth - 1) + node
        xv = gather_feature(values, feature[heap][:, None])[:, 0]
        node = node * 2 + torch.where(xv <= cmp[heap], 0, 1)
    return leaf_value[node]


def _descend_binned(tree: Tree, bins: torch.Tensor,
                    max_depth: int) -> torch.Tensor:
    return _descend(tree.feature, tree.split_bin, tree.leaf_value, bins,
                    max_depth)


def _descend_raw(tree: Tree, x: torch.Tensor, max_depth: int) -> torch.Tensor:
    return _descend(tree.feature, tree.threshold, tree.leaf_value, x,
                    max_depth)


def predict_binned(tree: Tree, bins: torch.Tensor, *,
                   max_depth: int) -> torch.Tensor:
    """Evaluate one tree on int32 bin ids; returns (n,) leaf values."""
    return _descend_binned(tree, bins, max_depth)


def predict_raw(tree: Tree, x: torch.Tensor, *,
                max_depth: int) -> torch.Tensor:
    """Evaluate one tree on raw float32 features (x <= threshold goes
    left)."""
    return _descend_raw(tree, x, max_depth)


def _forest_predict_scan(forest: Forest, x: torch.Tensor, *,
                         max_depth: int) -> torch.Tensor:
    """Sequential per-tree ensemble sum: the semantic oracle of the
    batched engine (:func:`repro_torch.core.predict.forest_predict`,
    bit-identical output).  Returns the *unscaled* sum."""
    acc = torch.zeros((x.shape[0],), dtype=torch.float32, device=x.device)
    for t in forest_trees(forest):
        acc = acc + _descend_raw(t, x, max_depth)
    return acc


def build_tree(bins: torch.Tensor, gh: torch.Tensor,
               candidates: torch.Tensor, *, max_depth: int, spec: HistSpec,
               l2: float = 1.0, gamma: float = 0.0,
               min_child_weight: float = 1e-6,
               return_leaf_nodes: bool = False, return_stats: bool = False):
    """Grow one tree on binned data, level by level.

    Every level works on the same frontier of ``F = 2^(max_depth-1)``
    nodes: at depth ``d`` ids occupy only ``[0, 2^d)``, and the empty
    tail has an all-zero histogram, fails ``min_child_weight`` at every
    bin and falls out as a passthrough.  Direct growth makes one
    ``ops.hist_levels`` and one ``ops.split_gain`` call per level.

    With ``spec.subtract`` (histogram subtraction) each level adds only
    the rows routed LEFT, keyed by parent, into a half panel of ``F/2``
    parents; each right child is ``parent - left`` from the previous
    level's panel, interleaved as children ``2p, 2p + 1``.  Level 0 is
    the same program: every row has child id 0.  Nodes not yet populated
    at a depth are re-zeroed, or ``0 - left`` would leak down the
    all-right spine of the carried panel.  So is every bucket that holds
    no rows (the histogram counts them, exactly): where all of a
    parent's rows in a bin went left, ``parent - left`` sums the same
    rows twice, and on the card, whose atomics add in no fixed order, it
    would leave a rounding residue that breaks the exact tie between an
    empty bin and its neighbour.  On the CPU that bucket is already 0.

    Args:
      bins: (n, f) int32 bin ids in [0, spec.nbins).
      gh: (n, 2) float32 grad/hess panel of this round.
      candidates: (f, k) candidate values (k = nbins - 1); only used to
        record raw thresholds for inference on unbinned data.
      spec: the histogram workload; ``spec.n_nodes`` must cover the
        frontier.
      return_leaf_nodes: also return each row's final leaf id.
      return_stats: also return a :class:`TreeStats`.

    Returns:
      A :class:`Tree`, extended to ``(Tree, node)`` with
      ``return_leaf_nodes`` and further to ``(..., stats)`` with
      ``return_stats`` (``node`` is the (n,) int32 leaf id).
    """
    frontier = 2 ** max(max_depth - 1, 0)
    if spec.n_nodes < frontier:
        raise ValueError(f"spec.n_nodes={spec.n_nodes} < frontier {frontier} "
                         f"for max_depth={max_depth}")
    nbins = spec.nbins
    lspec = spec.with_levels(1)          # one call = one level
    sspec = dataclasses.replace(lspec, n_nodes=frontier).child_view()
    half = sspec.n_nodes                 # parents of the left-only panel
    n, f = bins.shape
    dev = bins.device
    k = candidates.shape[1]
    rows = torch.arange(frontier, device=dev)

    n_inner = 2 ** max_depth - 1
    feature = torch.full((n_inner,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.full((n_inner,), nbins - 1, dtype=torch.int32,
                           device=dev)
    threshold = torch.full((n_inner,), float("inf"), dtype=torch.float32,
                           device=dev)
    level_stats = []
    node = torch.zeros((n,), dtype=torch.int32, device=dev)  # level-local id
    if spec.subtract:
        prev = torch.zeros((frontier, f, nbins, 2), dtype=torch.float32,
                           device=dev)
        prev_n = torch.zeros((frontier, f, nbins), dtype=torch.int32,
                             device=dev)                 # rows per bucket
    for depth in range(max_depth):
        if spec.subtract:
            left, left_n = ops.hist_levels(bins, node[None], gh, sspec)
            left, left_n = left[0], left_n[0]
            if frontier == 1:
                hist, cnt = left, left_n     # single-node level: the root
            else:
                hist = torch.stack([left, prev[:half] - left], dim=1)
                hist = hist.reshape(frontier, f, nbins, 2)
                cnt = torch.stack([left_n, prev_n[:half] - left_n], dim=1)
                cnt = cnt.reshape(frontier, f, nbins)
                keep = (rows < 2 ** depth)[:, None, None] & (cnt > 0)
                hist = torch.where(keep[..., None], hist, 0.0)
                cnt = torch.where(keep, cnt, 0)
            prev, prev_n = hist, cnt
        else:
            hist = ops.hist_levels(bins, node[None], gh, lspec)[0]

        gains, sbins = ops.split_gain(hist, l2=l2, gamma=gamma,
                                      min_child_weight=min_child_weight,
                                      backend=lspec.backend)   # (nodes, f)
        gains = gains[:frontier]
        sbins = sbins[:frontier]
        best_gain, best_f = argmax_nan_first(gains, dim=1)     # (nodes,)
        best_s = sbins[rows, best_f]
        do_split = best_gain > 0.0
        lvl_feature = torch.where(do_split, best_f, -1).to(torch.int32)
        lvl_sbin = torch.where(do_split, best_s, nbins - 1).to(torch.int32)
        lvl_thresh = torch.where(
            do_split,
            candidates[lvl_feature.clamp(min=0).long(),
                       lvl_sbin.clamp(0, k - 1).long()],
            float("inf"))
        lo, w = 2 ** depth - 1, 2 ** depth    # w: populated prefix
        feature[lo:lo + w] = lvl_feature[:w]
        split_bin[lo:lo + w] = lvl_sbin[:w]
        threshold[lo:lo + w] = lvl_thresh[:w]
        if return_stats:
            realized = torch.where(do_split, best_gain, 0.0)
            # histogram updates: the rows added this level, times f
            if spec.subtract:
                upd = (node % 2 == 0).to(torch.float32).sum() * f
            else:
                upd = torch.tensor(float(n * f), device=dev)
            level_stats.append((do_split.to(torch.int32).sum(),
                                _sequential_sum(realized), realized.max(),
                                upd))

        # route rows: left (2*node) if bin <= s else right (2*node + 1)
        nl = node.long()
        fidx = lvl_feature.clamp(min=0).long()[nl]
        row_bin = torch.gather(bins, 1, fidx[:, None])[:, 0]
        go_left = row_bin <= lvl_sbin[nl]
        node = node * 2 + torch.where(go_left, 0, 1).to(torch.int32)

    # leaf values from the final-level grad/hess totals (on the CPU the
    # adds run in row order, as the JAX package's scatter does; on the
    # card in fixed point, the same in any order)
    seg = ops.leaf_sums(node, gh, 2 ** max_depth, backend=spec.backend)
    leaf_value = -seg[:, 0] / (seg[:, 1] + l2)
    tree = Tree(feature, split_bin, threshold, leaf_value)
    out = (tree,)
    if return_leaf_nodes:
        out += (node,)
    if return_stats:
        out += (_tree_stats(level_stats, dev),)
    return out if len(out) > 1 else tree


def _sequential_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of a short float32 vector in index order.  XLA:CPU adds a
    vector of up to 32 elements (a frontier up to depth 6) that way;
    ``torch.sum`` does not."""
    total = x[0]
    for v in x[1:]:
        total = total + v
    return total


def _tree_stats(level_stats, device) -> TreeStats:
    if not level_stats:
        return TreeStats(torch.tensor(0, dtype=torch.int32, device=device),
                         *(torch.tensor(0.0, device=device),) * 3)
    ns, gs, gm, up = (torch.stack(a) for a in zip(*level_stats))
    return TreeStats(ns.sum().to(torch.int32), _sequential_sum(gs),
                     gm.max(), up.sum())
