"""Work counted from a cell's shapes, and the least time it needs on the
card's published peaks.

Every count is of the problem, not of an implementation: each input
byte read once, each output byte written once, integer ids at the least
whole number of bytes that holds them, and the operations the
mathematics needs (a compare, an add, a multiply each count one).  So a
count stays the same whatever implements the work, and a share of the
least time can never pass 100 % of the work that was really done.
"""

from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

PEAKS_FILE = Path(__file__).resolve().parent / "h100_sxm.json"


def peaks() -> dict:
    """The H100 SXM's published peaks (``h100_sxm.json``)."""
    return json.loads(PEAKS_FILE.read_text())


@dataclasses.dataclass(frozen=True)
class Work:
    bytes: float
    ops: float

    def __add__(self, other: "Work") -> "Work":
        return Work(self.bytes + other.bytes, self.ops + other.ops)


def id_bytes(count: int) -> int:
    """Least whole bytes that hold an id in ``[0, count)``."""
    return max(1, math.ceil(math.log2(max(count, 2)) / 8))


def hist_level(n: int, f: int, nbins: int, nodes: int) -> Work:
    """One level's gradient/hessian histogram: the rows' bin ids, node
    ids and float32 (g, h) read once, the (nodes, f, nbins) float32
    (G, H) panel written once; two adds a row a feature."""
    read = n * f * id_bytes(nbins) + n * id_bytes(nodes) + n * 8
    written = nodes * f * nbins * 2 * 4
    return Work(read + written, 2.0 * n * f)


def hist_tree(n: int, f: int, nbins: int, depth: int) -> list[Work]:
    """A tree's histogram levels, each at the nodes it has: 2^d at
    depth d."""
    return [hist_level(n, f, nbins, 2 ** d) for d in range(depth)]


def split_search(f: int, nbins: int, nodes: int) -> Work:
    """One level's split search over a (nodes, f, nbins) panel: the panel
    read once, a prefix sum (2 adds) and the gain (about 10 operations)
    a bucket."""
    buckets = nodes * f * nbins
    return Work(buckets * 2 * 4, 12.0 * buckets)


def proposal(n: int, f: int, k: int, strategy: str) -> Work:
    """A round's candidate grid: ``random`` draws k values a feature and
    sorts them; ``weighted_quantile`` sorts each feature's n values
    (n log2 n compares) and takes a prefix sum of their weights."""
    if strategy == "random":
        return Work(f * k * 4 * 2, f * k * math.log2(max(k, 2)))
    if strategy == "weighted_quantile":
        return Work(0.0, n * f * (math.log2(max(n, 2)) + 1))
    raise ValueError(f"no count for strategy {strategy!r}")


def fit_round(n: int, f: int, k: int, depth: int, strategy: str) -> Work:
    """One boosting round at its inputs and outputs: x (n, f) float32, the
    labels and the margin read once and the margin written once; the
    operations of grad/hess (6 a row), the proposal, binning (a search:
    log2(k + 1) compares a value), ``depth`` histogram levels and split
    searches over a frontier of 2^(depth - 1) nodes, routing (one compare
    a row a level) and the margin update (2 a row)."""
    nbins = k + 1
    frontier = 2 ** max(depth - 1, 0)
    io = Work(n * f * 4 + n * 4 + n * 4 * 2, 6.0 * n + 2.0 * n)
    binning = Work(0.0, n * f * math.ceil(math.log2(nbins)))
    hist = hist_level(n, f, nbins, frontier)
    search = split_search(f, nbins, frontier)
    levels = Work(0.0, depth * (hist.ops + search.ops + n))
    return io + binning + levels + Work(0.0, proposal(n, f, k, strategy).ops)


def forest_request(n: int, f: int, trees: int, depth: int) -> Work:
    """A scoring request: n rows of f float32 features read once, n
    float32 margins written once, the forest (features as ids, float32
    thresholds and leaves) read once; a compare a (row, tree, level), an
    add a (row, tree) and the closing multiply-add a row."""
    inner, leaves = 2 ** depth - 1, 2 ** depth
    forest = trees * (inner * (id_bytes(f + 1) + 4) + leaves * 4)
    return Work(n * f * 4 + n * 4 + forest,
                float(n) * trees * (depth + 1) + 2.0 * n)


def least_seconds(work: Work, table: dict | None = None) -> float:
    """The least time ``work`` needs: the larger of its bytes over the HBM
    rate and its operations over the float32 CUDA-core rate."""
    table = table or peaks()
    return max(work.bytes / table["hbm_bytes_per_s"],
               work.ops / table["fp32_flops_per_s"])


def share_pct(least_s: float, measured_s: float) -> float | None:
    """``least_s`` as a percentage of ``measured_s``; None without a
    measured time."""
    if not measured_s or measured_s <= 0:
        return None
    return 100.0 * least_s / measured_s
