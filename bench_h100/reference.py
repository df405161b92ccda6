"""The plain reference: boosting rounds and batch scoring in plain torch.

Nothing here comes from the program: the algorithms are written out from
their definitions (XGBoost's second-order gain, the hessian-weighted
quantile sketch, level-wise growth of a complete tree of static depth),
on the inputs that the benchmark makes and hands to both sides.  Each
function takes the precision it computes in.  The comparison
(``compare.py``) runs them in float64; the control runs them in
bfloat16, the precision below the configuration's float32, in the
program's place: every value stored in bfloat16, sums over rows
accumulated in float32 and rounded back, as the card's bfloat16 paths
accumulate.

Conventions shared with the program's documented semantics: a value's
bin is the number of candidates strictly below it; a split at bin s
sends a row left when its bin is <= s (raw: ``x <= candidates[s]``); a
node that does not split is a passthrough (feature -1, split bin k,
threshold +inf); leaves are ``-G / (H + l2)``.
"""

from __future__ import annotations

import torch


def _acc(dtype):
    """The dtype that sums over rows accumulate in: float64 for float64,
    float32 for float32 and below."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def base_margin(y: torch.Tensor, dtype) -> torch.Tensor:
    """The logistic base margin ``log(p / (1 - p))`` of the label mean."""
    p = y.to(dtype).mean().clamp(1e-6, 1 - 1e-6)
    return torch.log(p / (1 - p))


def grad_hess(margin: torch.Tensor, y: torch.Tensor):
    """Logistic loss: g = sigmoid(m) - y, h = sigmoid(m) (1 - sigmoid(m))."""
    p = torch.sigmoid(margin)
    return p - y.to(margin.dtype), p * (1 - p)


def bins_of(x: torch.Tensor, candidates: torch.Tensor) -> torch.Tensor:
    """(f, n) int64 bin ids: the candidates of each feature strictly below
    each value (``candidates`` (f, k) sorted)."""
    return torch.searchsorted(candidates.contiguous(), x.T.contiguous(),
                              side="left")


def random_grid(x: torch.Tensor, k: int,
                generator: torch.Generator) -> torch.Tensor:
    """k values of each column at rows drawn uniformly, sorted: (f, k)."""
    n, f = x.shape
    rows = torch.randint(0, n, (f, k), generator=generator, device=x.device)
    return torch.gather(x.T, 1, rows).sort(dim=1).values


def weighted_grid(x: torch.Tensor, h: torch.Tensor, k: int) -> torch.Tensor:
    """XGBoost's weighted quantile grid: for j = 1..k, the first value of
    each sorted column whose cumulative hessian weight reaches
    j / (k + 1) of the column's total.  Computed in ``h``'s dtype."""
    values, order = torch.sort(x.T.to(h.dtype), dim=1, stable=True)
    cw = torch.cumsum(h[order].to(_acc(h.dtype)), dim=1).to(h.dtype)
    steps = torch.arange(1, k + 1, device=x.device, dtype=h.dtype) / (k + 1)
    targets = steps[None, :] * cw[:, -1:]
    idx = torch.searchsorted(cw, targets.contiguous(), side="left")
    return torch.gather(values, 1, idx.clamp(max=x.shape[0] - 1))


def level_hist(bins: torch.Tensor, node: torch.Tensor, g: torch.Tensor,
               h: torch.Tensor, n_nodes: int, nbins: int):
    """(G, H), each (n_nodes, f, nbins) in ``g``'s dtype: the sums of the
    rows of each (node, feature, bin), a feature at a time, accumulated
    in ``_acc`` of that dtype."""
    f = bins.shape[0]
    size = n_nodes * nbins
    G = torch.zeros((n_nodes, f, nbins), dtype=g.dtype, device=g.device)
    H = torch.zeros_like(G)
    base = node * nbins
    for j in range(f):
        idx = base + bins[j]
        for out, w in ((G, g), (H, h)):
            s = torch.zeros(size, dtype=_acc(w.dtype), device=w.device)
            s.index_add_(0, idx, w.to(s.dtype))
            out[:, j] = s.view(n_nodes, nbins)
    return G, H


def split_gains(G: torch.Tensor, H: torch.Tensor, *, l2: float, gamma: float,
                min_child_weight: float):
    """Gains (n_nodes, f, nbins - 1) of every split s (left: bins <= s),
    ``0.5 (GL^2/(HL+l2) + GR^2/(HR+l2) - G^2/(H+l2)) - gamma``, and the
    mask of those where both sides hold ``min_child_weight`` of hessian;
    also each node's (HL, HR)."""
    GL = torch.cumsum(G, dim=2)[..., :-1]
    HL = torch.cumsum(H, dim=2)[..., :-1]
    Gt, Ht = G.sum(dim=2, keepdim=True), H.sum(dim=2, keepdim=True)
    GR, HR = Gt - GL, Ht - HL
    gain = 0.5 * (GL * GL / (HL + l2) + GR * GR / (HR + l2)
                  - Gt * Gt / (Ht + l2)) - gamma
    ok = (HL >= min_child_weight) & (HR >= min_child_weight)
    return gain, ok, HL, HR


def route(bins: torch.Tensor, node: torch.Tensor, feature: torch.Tensor,
          split_bin: torch.Tensor) -> torch.Tensor:
    """Next level's ids: left (2 node) where the row's bin on the node's
    feature is <= the node's split bin, else right (2 node + 1).
    ``feature``/``split_bin`` are this level's, indexed by ``node``."""
    col = feature.long().clamp(min=0)[node]
    b = bins.gather(0, col[None, :])[0]
    return 2 * node + (b > split_bin.long()[node]).long()


def grow(bins, g, h, grid, *, depth, l2, gamma, min_child_weight):
    """One complete tree of ``depth`` grown level by level in ``g``'s dtype:
    at each node the split of largest gain among the legal ones (first
    feature, then first bin, on ties), a passthrough where none gains.
    Returns (feature, split_bin, threshold, leaf_value, leaf id a row)."""
    f, k = grid.shape
    nbins = k + 1
    dev = g.device
    n_inner = 2 ** depth - 1
    feature = torch.full((n_inner,), -1, dtype=torch.int32, device=dev)
    split_bin = torch.full((n_inner,), k, dtype=torch.int32, device=dev)
    threshold = torch.full((n_inner,), float("inf"), dtype=torch.float32,
                           device=dev)
    node = torch.zeros(bins.shape[1], dtype=torch.long, device=dev)
    for d in range(depth):
        m = 2 ** d
        G, H = level_hist(bins, node, g, h, m, nbins)
        gain, ok, _, _ = split_gains(G, H, l2=l2, gamma=gamma,
                                     min_child_weight=min_child_weight)
        gain = torch.where(ok, gain, float("-inf")).reshape(m, -1)
        best, flat = gain.max(dim=1)
        split = best > 0
        bf = (flat // k).to(torch.int32)
        bs = (flat % k).to(torch.int32)
        lo = m - 1
        feature[lo:lo + m] = torch.where(split, bf, -1)
        split_bin[lo:lo + m] = torch.where(split, bs, k)
        threshold[lo:lo + m] = torch.where(
            split, grid[bf.long(), bs.long()].to(torch.float32),
            float("inf"))
        node = route(bins, node, feature[lo:lo + m], split_bin[lo:lo + m])
    leaves = 2 ** depth
    acc = _acc(g.dtype)
    Gl = torch.zeros(leaves, dtype=acc, device=dev).index_add_(
        0, node, g.to(acc)).to(g.dtype)
    Hl = torch.zeros(leaves, dtype=acc, device=dev).index_add_(
        0, node, h.to(acc)).to(g.dtype)
    return feature, split_bin, threshold, -Gl / (Hl + l2), node


def fit(x: torch.Tensor, y: torch.Tensor, model: dict, *, strategy: str,
        k: int, generator: torch.Generator | None, dtype) -> dict:
    """A whole fit in ``dtype``: base margin, then ``model['n_trees']``
    rounds of grad/hess, a grid (``random`` or ``weighted_quantile``),
    binning, growth and the margin update.  Returns the forest as the
    program's checkpoint arrays (torch, on ``x``'s device)."""
    xd = x.to(dtype)
    base = base_margin(y, dtype)
    margin = torch.full((x.shape[0],), float(base), dtype=dtype,
                        device=x.device)
    depth = model["max_depth"]
    out = {key: [] for key in ("feature", "split_bin", "threshold",
                               "leaf_value", "candidates")}
    for _ in range(model["n_trees"]):
        g, h = grad_hess(margin, y)
        if strategy == "random":
            grid = random_grid(xd, k, generator)
        elif strategy == "weighted_quantile":
            grid = weighted_grid(xd, h, k)
        else:
            raise ValueError(f"no reference for strategy {strategy!r}")
        bins = bins_of(xd, grid)
        feat, sbin, thr, leaf, node = grow(
            bins, g, h, grid, depth=depth, l2=model["l2"],
            gamma=model["gamma"], min_child_weight=model["min_child_weight"])
        margin = margin + model["learning_rate"] * leaf[node]
        for key, a in zip(out, (feat, sbin, thr, leaf.to(torch.float32),
                                grid.to(torch.float32))):
            out[key].append(a)
    return {key: torch.stack(a) for key, a in out.items()}


def margins(x: torch.Tensor, feature: torch.Tensor, threshold: torch.Tensor,
            leaf: torch.Tensor, *, base: float, learning_rate: float,
            depth: int, dtype, chunk: int = 50) -> torch.Tensor:
    """``base + learning_rate * (sum of each row's leaf over the trees)``
    in ``dtype``: a row goes left where ``x <= threshold`` (NaN goes right);
    float64 sums a chunk of trees at once, a lower precision adds tree by
    tree, rounding each add."""
    n = x.shape[0]
    trees, n_inner = feature.shape
    xd = x.to(dtype)
    thr = threshold.to(dtype).reshape(-1)
    leaves = leaf.to(dtype).reshape(-1)
    feat = feature.long().reshape(-1)
    acc = torch.zeros(n, dtype=dtype, device=x.device)
    for t0 in range(0, trees, chunk):
        c = min(chunk, trees - t0)
        tree = torch.arange(t0, t0 + c, device=x.device)
        node = torch.zeros((n, c), dtype=torch.long, device=x.device)
        for d in range(depth):
            at = tree * n_inner + (2 ** d - 1) + node
            xv = xd.gather(1, feat[at].clamp(min=0))
            node = 2 * node + (~(xv <= thr[at])).long()
        vals = leaves[tree * 2 ** depth + node]
        if dtype == torch.float64:
            acc += vals.sum(dim=1)
        else:
            for j in range(c):
                acc = acc + vals[:, j]
    return base + learning_rate * acc
