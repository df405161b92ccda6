"""Batched forest inference engine: level-synchronous traversal.

The whole stacked :class:`repro_torch.core.tree.Forest` goes to one
:func:`repro_torch.kernels.ops.forest_sum` call, which advances every
(row, tree) pair through all depth levels and adds each row's leaf
values in tree order: on the card one launch of the forest-sum kernel a
request (counted in ``repro_torch.kernels.traverse.forest_launches``),
on the CPU the plain version, ``tree_chunk`` trees at a time.

Exactness: the leaf values are added onto a +0.0 accumulator in tree
order, so the ensemble sum is the same float32 adds in the same order as
the per-tree oracle and the JAX engine: **bit-identical** (the JAX
engine's padding trees add exact zeros onto a sum that is never -0.0,
which changes no bit, so none are added here).

The binned path (``binned=True``) traverses on int32 bin ids
(``bin <= split_bin``).  NaN contract: raw NaN compares False at every
node and routes RIGHT; binned NaN sits in the LAST bin and follows that
bin's routing.
"""

from __future__ import annotations

import torch

from ..kernels import ops
from ..kernels.ops import TraverseSpec
from . import tree as tree_lib

DEFAULT_TREE_CHUNK = 25


def _forest_sum(forest: tree_lib.Forest, values, max_depth: int,
                spec: TraverseSpec, *, base: float = 0.0,
                scale: float = 1.0) -> torch.Tensor:
    """``base + scale * sum`` on the forest's device; ``(0,)`` for an
    empty batch without a launch."""
    dtype = torch.int32 if spec.binned else torch.float32
    values = torch.as_tensor(values, device=forest.feature.device).to(
        dtype).contiguous()
    if values.shape[0] == 0:
        return torch.zeros((0,), dtype=torch.float32, device=values.device)
    cmp = forest.split_bin if spec.binned else forest.threshold
    return ops.forest_sum(values, forest.feature, cmp, forest.leaf_value,
                          spec, max_depth=max_depth, base=base, scale=scale)


def margin(forest: tree_lib.Forest, values, base_score: float,
           learning_rate: float, *, max_depth: int,
           spec: TraverseSpec) -> torch.Tensor:
    """``base + lr * ensemble_sum``: the one margin path of
    :meth:`GBDTModel.predict`.  An empty ``(0, f)`` batch returns
    ``(0,)`` without a launch.

    The closing affine transform is two separate roundings, never a
    fused multiply-add: fused, ``base + lr * sum`` would round once where
    the JAX engine rounds twice (a 1-ulp drift).  On the card the
    forest-sum kernel applies them (``__fmul_rn`` then ``__fadd_rn``), so
    a request is one launch; on the CPU two PyTorch operations.
    """
    return _forest_sum(forest, values, max_depth, spec, base=base_score,
                       scale=learning_rate)


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
        ``tree_chunk`` sets the plain version's chunks on the CPU and
        changes no bit; on the card the forest is one launch.

    Returns:
      (n,) float32 sum of per-tree leaf values; ``(0,)`` for an empty
      batch without a launch.
    """
    if spec is None:
        spec = TraverseSpec(tree_chunk=tree_chunk or DEFAULT_TREE_CHUNK,
                            binned=binned, backend=backend)
    return _forest_sum(forest, values, max_depth, spec)
