"""Batched forest inference engine: level-synchronous traversal.

The stacked :class:`repro_torch.core.tree.Forest` is traversed a chunk
of ``C`` trees at a time: one :func:`repro_torch.kernels.ops.
traverse_chunk` call (one CUDA launch on the card) advances every
(row, tree) pair of the chunk through all depth levels and returns the
per-tree leaf values ``(rows, C)``.

Exactness: the per-tree leaf values are added onto the accumulator in
tree order, across and within chunks, so the ensemble sum is the same
float32 adds in the same order as the per-tree oracle and the JAX
engine: **bit-identical** (padding trees are passthrough with leaf 0,
adding exact zeros).  That is one small elementwise launch per tree.
On the card the traversal launches are counted in
``repro_torch.kernels.traverse.launches``: one per chunk.

The binned path (``binned=True``) traverses on int32 bin ids
(``bin <= split_bin``).  NaN contract: raw NaN compares False at every
node and routes RIGHT; binned NaN sits in the LAST bin and follows that
bin's routing.
"""

from __future__ import annotations

import numpy as np
import torch

from ..kernels import ops
from ..kernels.ops import TraverseSpec
from . import tree as tree_lib

DEFAULT_TREE_CHUNK = 25

# split bin of a binned passthrough padding tree: above any bin id
_BINNED_PASSTHROUGH = 2 ** 20


def _forest_sum(forest: tree_lib.Forest, values: torch.Tensor,
                max_depth: int, spec: TraverseSpec) -> torch.Tensor:
    t = forest.n_trees
    c = spec.tree_chunk
    pad = -t % c
    feat, leafv = forest.feature, forest.leaf_value
    cmp = forest.split_bin if spec.binned else forest.threshold
    if pad:
        # passthrough zero-leaf padding trees: every row descends the
        # all-left spine into leaf 0 and contributes an exact 0.0
        feat = torch.cat([feat, feat.new_full((pad, feat.shape[1]), -1)])
        cmp = torch.cat([cmp, cmp.new_full(
            (pad, cmp.shape[1]),
            _BINNED_PASSTHROUGH if spec.binned else np.inf)])
        leafv = torch.cat([leafv, leafv.new_zeros((pad, leafv.shape[1]))])
    acc = torch.zeros((values.shape[0],), dtype=torch.float32,
                      device=values.device)
    for s in range(0, t + pad, c):
        vals = ops.traverse_chunk(values, feat[s:s + c], cmp[s:s + c],
                                  leafv[s:s + c], spec,
                                  max_depth=max_depth)   # (n, C)
        # accumulate in tree order: bit-identical to the per-tree scan
        for i in range(c):
            acc += vals[:, i]
    return acc


def _as_values(values, spec: TraverseSpec,
               device: torch.device) -> torch.Tensor:
    dtype = torch.int32 if spec.binned else torch.float32
    return torch.as_tensor(values, device=device).to(dtype).contiguous()


def margin(forest: tree_lib.Forest, values, base_score: float,
           learning_rate: float, *, max_depth: int,
           spec: TraverseSpec) -> torch.Tensor:
    """``base + lr * ensemble_sum``: the one margin path of
    :meth:`GBDTModel.predict`.  An empty ``(0, f)`` batch returns
    ``(0,)`` without a launch.

    The closing affine transform is two separate operations, never a
    fused multiply-add: fused, ``base + lr * sum`` would round once where
    the JAX engine rounds twice (a 1-ulp drift).
    """
    total = forest_predict(forest, values, max_depth=max_depth, spec=spec)
    scaled = learning_rate * total
    return base_score + scaled


def forest_predict(forest: tree_lib.Forest, values, *, max_depth: int,
                   spec: TraverseSpec | None = None, binned: bool = False,
                   tree_chunk: int | None = None,
                   backend: str = "auto") -> torch.Tensor:
    """Unscaled ensemble sum over a stacked forest, batched across trees.

    Args:
      values: (n, f) raw float32 features, or integer bin ids when
        ``binned`` (e.g. from ``GBDTModel.bin_features``); moved to the
        forest's device.
      spec: full :class:`TraverseSpec`; overrides the ``binned`` /
        ``tree_chunk`` / ``backend`` conveniences when given.

    Returns:
      (n,) float32 sum of per-tree leaf values; ``(0,)`` for an empty
      batch without a launch.
    """
    if spec is None:
        spec = TraverseSpec(tree_chunk=tree_chunk or DEFAULT_TREE_CHUNK,
                            binned=binned, backend=backend)
    values = _as_values(values, spec, forest.feature.device)
    if values.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=values.device)
    return _forest_sum(forest, values, max_depth, spec)
