"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against on the card,
and the path a CPU tensor takes.  Each mirrors its counterpart in the
JAX package's ``kernels/ref.py`` index for index, so the tests can hold
the two packages bit for bit.
"""

from __future__ import annotations

import torch

# A "chunk" is C stacked trees in heap SoA layout: feature (C, 2^d - 1),
# cmp (C, 2^d - 1) -- raw thresholds (float32) or split bins (int32) --
# and leaf (C, 2^d).  All C trees advance one depth level per step; the
# result is PER-TREE leaf values (n, C), so the caller controls the order
# in which the ensemble is summed.


def gather_feature(values: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    """``values[row, fidx[row, j]]`` with the JAX package's gather rules.

    Ids below 0 are clipped to 0 (the -1 passthrough reads feature 0); an
    id past the last feature reads what a JAX gather fills out of bounds:
    NaN for floats, the most negative value for signed ints (the largest
    for unsigned).  So a malformed forest routes as in the reference, and
    nothing is read outside the row.
    """
    f = values.shape[1]
    fidx = fidx.long().clamp(min=0)
    xv = torch.gather(values, 1, fidx.clamp(max=f - 1))
    if values.is_floating_point():
        fill = float("nan")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.min if values.dtype.is_signed else info.max
    return torch.where(fidx < f, xv, fill)


def traverse_chunk_ref(values: torch.Tensor, feature: torch.Tensor,
                       cmp: torch.Tensor, leaf: torch.Tensor, *,
                       max_depth: int) -> torch.Tensor:
    """Per-tree leaf values of a stacked tree chunk, level by level.

    The same indexing as the per-tree descent ``tree._descend_raw`` /
    ``tree._descend_binned``: at depth ``d`` the heap index is
    ``2^d - 1 + node``, the passthrough feature -1 is clipped to 0 before
    the value gather (:func:`gather_feature`), and the split rule is
    ``value <= cmp`` (NaN compares False, so raw NaN rows route RIGHT).

    Args:
      values: (n, f) raw float32 features or int32 bin ids; the dtype
        carries the mode.
      feature: (C, 2^max_depth - 1) int32 split features; -1 = passthrough.
      cmp: (C, 2^max_depth - 1) float32 thresholds or int32 split bins.
      leaf: (C, 2^max_depth) float32 leaf values.

    Returns:
      (n, C) float32 per-tree leaf values.
    """
    n = values.shape[0]
    C = feature.shape[0]
    tree = torch.arange(C, device=values.device)          # (C,) broadcasts
    node = torch.zeros((n, C), dtype=torch.long, device=values.device)
    for depth in range(max_depth):
        heap = (2 ** depth - 1) + node                    # (n, C)
        xv = gather_feature(values, feature[tree, heap])
        node = node * 2 + torch.where(xv <= cmp[tree, heap], 0, 1)
    return leaf[tree, node]
