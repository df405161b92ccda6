"""The comparison that decides ``correct``: what the timed path produced,
judged by the plain reference in float64.

A fit is judged round by round, following its own trees: the reference
makes each round's margin from the base margin and the fit's earlier
trees, its own grad/hess from that margin, its own bins from the fit's
grid, its own histograms at every node of every level (the rows routed
by the fit's splits), and then asks of the fit:

* ``cand_bad``: grid values that are not values of their column, or out
  of order (an exact count, limit 0);
* ``grid_repeat`` (a grid re-proposed each round): rounds whose grid
  equals the round before's, value for value (an exact count, limit 0);
* ``cand_rank_gap`` (weighted quantile): how far each grid value's
  cumulative hessian weight lies from its target j/(k+1), as a share of
  the column's total;
* ``thresh_bad``: inner nodes whose threshold is not
  ``grid[feature, split_bin]``, or whose passthrough is not (-1, k, +inf)
  (an exact count, limit 0);
* ``split_gap``: how far the gain of each chosen split (0 for a
  passthrough) falls below the best legal gain at that node, beyond the
  float32 rounding that both gains may carry in the program
  (:func:`_gain_rounding`), over the larger of that best gain and the
  tree's median best gain; a split whose side's hessian lies within
  rounding of ``min_child_weight`` may be taken or refused;
* ``leaf_gap``: how far each leaf lies from ``-G/(H + l2)`` of its rows,
  over the larger of that leaf and the tree's median leaf (absolute).

A wrong margin update shows in the next round's grad/hess, and so in its
leaves.  A batch of scores is judged by ``margin_gap``: the widest gap of
a row's margin to the reference's, over the larger of that margin and the
batch's median margin (absolute).
"""

from __future__ import annotations

import torch

from . import reference

F64 = torch.float64


def _median(a: torch.Tensor) -> float:
    return float(a.median()) if a.numel() else 0.0


def fit_numbers(x: torch.Tensor, y: torch.Tensor, fitted: dict, model: dict,
                *, strategy: str, k: int,
                repropose: bool) -> tuple[dict, dict]:
    """Judge one fit.  ``fitted`` holds its arrays (``feature``,
    ``split_bin``, ``threshold``, ``leaf_value``, ``candidates``) as torch
    tensors; ``model`` the configuration's GBDT settings; ``repropose``
    whether the traffic asks for a new grid each round.  The base margin
    is the reference's own: a wrong one in the fit shows in its leaves.
    Returns (numbers, where the worst of each was found)."""
    dev = x.device
    n, f = x.shape
    depth, lr, l2 = model["max_depth"], model["learning_rate"], model["l2"]
    mcw, gamma = model["min_child_weight"], model["gamma"]
    feature = fitted["feature"].to(dev).long()
    split_bin = fitted["split_bin"].to(dev).long()
    threshold = fitted["threshold"].to(dev)
    leaf_value = fitted["leaf_value"].to(dev).to(F64)
    grids = fitted["candidates"].to(dev)
    trees = feature.shape[0]
    sorted_x = torch.sort(x.T.contiguous(), dim=1)
    numbers = {"cand_bad": 0, "thresh_bad": 0, "split_gap": 0.0,
               "leaf_gap": 0.0}
    if repropose:
        numbers["grid_repeat"] = 0
    if strategy == "weighted_quantile":
        numbers["cand_rank_gap"] = 0.0
    where: dict = {}
    want = (trees if repropose else 1, f, k)
    if tuple(grids.shape) != want or trees != model["n_trees"]:
        numbers["cand_bad"] += 1
        where["cand_bad"] = {"grids": list(grids.shape), "want": list(want),
                             "trees": trees}
        return numbers, where

    margin = torch.full((n,), float(reference.base_margin(y, F64)),
                        dtype=F64, device=dev)
    for r in range(trees):
        g, h = reference.grad_hess(margin, y)
        grid = grids[min(r, grids.shape[0] - 1)]
        if r < grids.shape[0]:
            _judge_grid(grid, sorted_x, h, strategy, numbers, where, r)
        if repropose and r and torch.equal(grid, grids[r - 1]):
            numbers["grid_repeat"] += 1
            where.setdefault("grid_repeat", {"round": r})
        bins = reference.bins_of(x, grid)
        node, best_chosen = _judge_levels(
            bins, g, h, grid, feature[r], split_bin[r], threshold[r],
            depth=depth, l2=l2, gamma=gamma, mcw=mcw, numbers=numbers,
            where=where, r=r)
        _judge_splits(best_chosen, numbers, where, r)
        _judge_leaves(node, g, h, leaf_value[r], l2, numbers, where, r)
        margin = margin + lr * leaf_value[r][node]
    return numbers, where


def _worse(numbers, where, key, value, detail) -> None:
    if value > numbers[key]:
        numbers[key] = value
        where[key] = detail


def _judge_grid(grid, sorted_x, h, strategy, numbers, where, r) -> None:
    values, order = sorted_x
    n = values.shape[1]
    pos = torch.searchsorted(values, grid.contiguous(), side="left")
    found = values.gather(1, pos.clamp(max=n - 1)) == grid
    found &= pos < n
    unsorted = (grid[:, 1:] < grid[:, :-1]).sum()
    bad = int((~found).sum() + unsorted)
    if bad:
        numbers["cand_bad"] += bad
        where.setdefault("cand_bad", {"round": r, "not_in_column":
                                      int((~found).sum()),
                                      "out_of_order": int(unsorted)})
    if strategy != "weighted_quantile":
        return
    cw = torch.cumsum(h[order], dim=1)
    total = cw[:, -1:]
    k = grid.shape[1]
    target = (torch.arange(1, k + 1, device=grid.device, dtype=F64)
              / (k + 1))[None, :] * total
    zero = torch.zeros_like(total)
    padded = torch.cat([zero, cw], dim=1)
    below = padded.gather(1, pos.clamp(max=n))
    upto = padded.gather(1, torch.searchsorted(values, grid.contiguous(),
                                               side="right"))
    gap = torch.maximum(below - target, target - upto).clamp(min=0) / total
    worst = float(gap.max())
    if worst > numbers["cand_rank_gap"]:
        i = int(gap.argmax())
        _worse(numbers, where, "cand_rank_gap", worst,
               {"round": r, "feature": i // k, "j": i % k})


def _judge_levels(bins, g, h, grid, feature, split_bin, threshold, *, depth,
                  l2, gamma, mcw, numbers, where, r):
    f, k = grid.shape
    nbins = k + 1
    dev = g.device
    split = feature >= 0
    legal = (feature >= -1) & (feature < f)
    legal &= torch.where(split, (split_bin >= 0) & (split_bin < k),
                         split_bin == k)
    fc, sc = feature.clamp(0, f - 1), split_bin.clamp(0, k - 1)
    want = torch.where(split, grid[fc, sc], torch.full_like(threshold,
                                                            float("inf")))
    legal &= threshold == want
    bad = int((~legal).sum())
    if bad:
        numbers["thresh_bad"] += bad
        where.setdefault("thresh_bad", {"round": r, "nodes": bad})

    node = torch.zeros(bins.shape[1], dtype=torch.long, device=dev)
    best_all, chosen_all, info_all = [], [], []
    for d in range(depth):
        m, lo = 2 ** d, 2 ** d - 1
        G, H = reference.level_hist(bins, node, g, h, m, nbins)
        gain, _, HL, HR = reference.split_gains(
            G, H, l2=l2, gamma=gamma, min_child_weight=mcw)
        unc, slack = _gain_rounding(G, H, HL, HR, l2)
        # a split whose side lies within rounding of min_child_weight may
        # be taken or refused: it is not the best that a refusal is held
        # to, and it is legal where chosen
        sure = (HL >= mcw + slack) & (HR >= mcw + slack)
        fair = (HL >= mcw - slack) & (HR >= mcw - slack)
        best, flat = torch.where(sure, gain, float("-inf")).reshape(
            m, -1).max(1)
        best = best.clamp(min=0)
        lf, ls = feature[lo:lo + m], split_bin[lo:lo + m]
        rows = torch.arange(m, device=dev)
        fcl, scl = lf.clamp(0, f - 1), ls.clamp(0, k - 1)
        bf, bs = flat // k, flat % k
        raw = gain[rows, fcl, scl]
        split_here = lf >= 0
        chosen = torch.where(split_here, torch.where(
            fair[rows, fcl, scl], raw, -best - 1.0), torch.zeros_like(raw))
        # the rounding that both gains may carry, and nothing beyond it
        rounding = torch.where(best > 0, unc[rows, bf, bs], 0.0) + \
            torch.where(split_here, unc[rows, fcl, scl], 0.0)
        populated = H.sum(dim=(1, 2)) > 0
        populated |= torch.bincount(node, minlength=m) > 0
        info = torch.stack([
            torch.full_like(raw, d), rows.to(raw.dtype),
            torch.bincount(node, minlength=m).to(raw.dtype),
            HL[rows, bf, bs], HR[rows, bf, bs],
            HL[rows, fcl, scl], HR[rows, fcl, scl], rounding], dim=1)
        best_all.append(best[populated])
        chosen_all.append(chosen[populated])
        info_all.append(info[populated])
        node = reference.route(bins, node, lf, ls)
        del G, H, gain, HL, HR
    return node, (torch.cat(best_all), torch.cat(chosen_all),
                  torch.cat(info_all))


def _gain_rounding(G, H, HL, HR, l2):
    """(How far the program's float32 gain of each split may lie from its
    exact gain, how far a side's hessian sum may lie from its exact sum)
    for a level's exact histograms ``G``, ``H`` (nodes, f, nbins).

    The program sums each bucket exactly (fixed point on the card) and
    rounds it to float32, then takes the prefix sums over bins and
    ``GR = G - GL``, ``HR = H - HL`` in float32: a side's sum lies within
    ``u = 2^-24 * nbins * sum |bucket|`` of exact.  That moves the gain
    ``0.5 (GL^2/(HL+l2) + GR^2/(HR+l2) - G^2/(H+l2))`` by at most
    ``|GL| uG/(HL+l2) + GL^2 uH/(HL+l2)^2`` and the same of the right
    side, and the float32 evaluation of its three terms by a few ulps
    of each (4 of the largest).  A tiny side of a node of millions of
    rows makes the first large; a gain far below its terms, the last."""
    eps, nbins = 2.0 ** -24, G.shape[2]
    uG = eps * nbins * G.abs().sum(dim=2, keepdim=True)
    uH = eps * nbins * H.sum(dim=2, keepdim=True)
    GL = torch.cumsum(G, dim=2)[..., :-1]
    Gt = G.sum(dim=2, keepdim=True)
    GR, Ht = Gt - GL, H.sum(dim=2, keepdim=True)
    left, right = GL * GL / (HL + l2), (GR * GR) / (HR + l2)
    unc = (GL.abs() * uG + left * uH) / (HL + l2) + \
        (GR.abs() * uG + right * uH) / (HR + l2) + \
        4 * eps * (left + right + Gt * Gt / (Ht + l2))
    return unc, uH


def _judge_splits(best_chosen, numbers, where, r) -> None:
    best, chosen, info = best_chosen
    if best.numel() == 0:
        return
    scale = torch.clamp(best, min=max(_median(best), 1e-300))
    gap = ((best - chosen - info[:, 7]) / scale).clamp(min=0)
    i = int(gap.argmax())
    depth, node, rows, hl, hr, chl, chr_, rounding = info[i].tolist()
    _worse(numbers, where, "split_gap", float(gap[i]),
           {"round": r, "depth": int(depth), "node": int(node),
            "rows": int(rows), "best": float(best[i]),
            "chosen": float(chosen[i]), "rounding": rounding,
            "best_HL_HR": [hl, hr], "chosen_HL_HR": [chl, chr_]})


def _judge_leaves(node, g, h, leaf, l2, numbers, where, r) -> None:
    leaves = leaf.shape[0]
    G = torch.bincount(node, weights=g, minlength=leaves)
    H = torch.bincount(node, weights=h, minlength=leaves)
    rows = torch.bincount(node, minlength=leaves)
    want = -G / (H + l2)
    med = max(_median(want[rows > 0].abs()), 1e-300)
    gap = (leaf - want).abs() / want.abs().clamp(min=med)
    i = int(gap.argmax())
    _worse(numbers, where, "leaf_gap", float(gap[i]),
           {"round": r, "leaf": i, "rows": int(rows[i]),
            "got": float(leaf[i]), "want": float(want[i])})


def score_numbers(x: torch.Tensor, got: torch.Tensor, forest: dict,
                  spec: dict) -> tuple[dict, dict]:
    """Judge a batch of margins ``got`` of rows ``x`` against the float64
    reference over the benchmark's own forest arrays (numpy)."""
    dev = x.device
    want = reference.margins(
        x, torch.as_tensor(forest["forest/feature"], device=dev),
        torch.as_tensor(forest["forest/threshold"], device=dev),
        torch.as_tensor(forest["forest/leaf_value"], device=dev),
        base=spec["base_score"], learning_rate=spec["learning_rate"],
        depth=spec["max_depth"], dtype=F64)
    got = got.to(dev).to(F64)
    med = max(_median(want.abs()), 1e-300)
    gap = (got - want).abs() / want.abs().clamp(min=med)
    gap = torch.where(torch.isnan(gap), torch.full_like(gap, float("inf")),
                      gap)
    i = int(gap.argmax())
    return ({"margin_gap": float(gap[i])},
            {"margin_gap": {"row": i, "got": float(got[i]),
                            "want": float(want[i])}})


def merge(acc: dict, numbers: dict) -> dict:
    """The worse of two readings of each number (the ``_bad`` counts add)."""
    for key, value in numbers.items():
        if key.endswith("_bad"):
            acc[key] = acc.get(key, 0) + value
        else:
            acc[key] = max(acc[key], value) if key in acc else value
    return acc


def held(numbers: dict, limits: dict) -> bool:
    """Every number of ``limits`` read and within its limit (a number
    without a limit, or one that is not a number, fails)."""
    return set(numbers) == set(limits) and all(
        value == value and value <= limits[key]
        for key, value in numbers.items())
