"""The scoring cell's forest, made from the seed.

A frozen copy of the draws of ``synthetic_gbdt`` in
``repro_torch/launch/serve_gbdt.py`` (features, split bins, passthrough
nodes, leaf values, in that order from ``numpy.random.default_rng``),
except that each feature's candidate grid is drawn from the scored
table's own rows, so that thresholds fall among the data.  Every inner
node's threshold is ``candidates[feature, split_bin]``; a passthrough
node carries (-1, +inf, k).  The arrays are numpy: the benchmark hands
the same ones to the program (through its model loading) and to the
plain reference.
"""

from __future__ import annotations

import numpy as np
import torch


def arrays(table: torch.Tensor, spec: dict, seed: int) -> dict:
    """The forest of ``spec`` (``n_trees``, ``max_depth``, ``n_candidates``,
    ``passthrough_frac``, ``leaf_scale``) over ``table`` (rows, f), as the
    program's checkpoint arrays."""
    rng = np.random.default_rng(seed)
    n_rows, f = table.shape
    trees, depth, k = spec["n_trees"], spec["max_depth"], spec["n_candidates"]
    n_inner, n_leaves = 2 ** depth - 1, 2 ** depth
    rows = torch.as_tensor(rng.integers(0, n_rows, size=(f, k)),
                           device=table.device)
    cols = torch.arange(f, device=table.device)[:, None]
    cands = np.sort(table[rows, cols].cpu().numpy().astype(np.float32), axis=1)

    feature = rng.integers(0, f, size=(trees, n_inner)).astype(np.int32)
    split_bin = rng.integers(0, k, size=(trees, n_inner)).astype(np.int32)
    passthrough = rng.random(size=(trees, n_inner)) < spec["passthrough_frac"]
    feature = np.where(passthrough, -1, feature).astype(np.int32)
    split_bin = np.where(passthrough, k, split_bin).astype(np.int32)
    threshold = cands[feature.clip(0), split_bin.clip(max=k - 1)]
    threshold = np.where(passthrough, np.inf, threshold).astype(np.float32)
    leaf_value = (spec["leaf_scale"] * rng.normal(size=(trees, n_leaves))
                  ).astype(np.float32)
    return {"forest/feature": feature, "forest/split_bin": split_bin,
            "forest/threshold": threshold, "forest/leaf_value": leaf_value,
            "candidates": cands[None]}
