"""Stacked decision trees and their per-tree predictors.

Heap layout (0-based): inner node i has children 2i+1 / 2i+2; level d
occupies indices [2^d - 1, 2^(d+1) - 2]; leaves are the 2^max_depth
level-(max_depth) nodes.  A passthrough node has feature -1, threshold
+inf and split bin nbins-1: every row goes LEFT.

Split semantics (as in the JAX package):
  row goes left  <=>  bin_id <= split_bin  <=>  x <= threshold
where threshold = candidates[feature, split_bin].

The per-tree descent here is the oracle of the batched engine in
:mod:`repro_torch.core.predict`; tree growth arrives with the training
slice.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..kernels.ref import gather_feature


class Tree(NamedTuple):
    """A single fitted tree (all tensors static-shaped)."""
    feature: torch.Tensor     # (2^depth - 1,) int32; -1 = passthrough
    split_bin: torch.Tensor   # (2^depth - 1,) int32; nbins-1 for passthrough
    threshold: torch.Tensor   # (2^depth - 1,) float32; +inf for passthrough
    leaf_value: torch.Tensor  # (2^depth,) float32


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
