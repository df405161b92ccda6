"""The work counts behind every roofline and mfu share, at the cells' real
shapes, and the shares they give."""

import math

import pytest

from bench_h100 import counts, harness, workloads
from bench_h100.devtrace import Activity, Trace


def _shape(workload):
    """(train rows, features, k) of a fit cell, from its files."""
    cell = harness.load_cell(workload)
    return (cell["config"]["train_rows"], cell["config"]["features"],
            cell["traffic"]["n_candidates"])


HIGGS = "higgs.fit.random.k50"
WIRETAP = "wiretap.fit.random.k255"


def test_peaks_are_the_published_h100_sxm():
    p = counts.peaks()
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert p["bf16_flops_per_s"] == 989e12
    assert p["fp32_flops_per_s"] == 67e12


@pytest.mark.parametrize("count,want", [(2, 1), (51, 1), (256, 1), (257, 2),
                                        (32, 1), (65536, 2), (65537, 3)])
def test_id_bytes(count, want):
    assert counts.id_bytes(count) == want


@pytest.mark.parametrize("workload", [HIGGS, WIRETAP])
@pytest.mark.parametrize("depth", range(6))
def test_hist_level_at_cell_shapes(workload, depth):
    n, f, k = _shape(workload)
    nodes = 2 ** depth
    w = counts.hist_level(n, f, k + 1, nodes)
    # one byte a bin id (<= 256 bins), one a node id, 8 a (g, h) pair
    assert w.bytes == n * f + n + 8 * n + nodes * f * (k + 1) * 8
    assert w.ops == 2 * n * f
    assert counts.hist_tree(n, f, k + 1, 6)[depth] == w


def test_hist_tree_higgs_least_time():
    n, f, k = _shape(HIGGS)
    assert (n, f, k) == (5_000_000, 28, 50)
    tree = counts.hist_tree(n, f, k + 1, 6)
    assert sum(w.bytes for w in tree) == 6 * 185_000_000 + 63 * 28 * 51 * 8
    assert sum(counts.least_seconds(w) for w in tree) == pytest.approx(
        1_110_719_712 / 3.35e12)


@pytest.mark.parametrize("strategy", ["random", "weighted_quantile"])
def test_fit_round_higgs(strategy):
    (n, f, k), depth = _shape(HIGGS), 6
    w = counts.fit_round(n, f, k, depth, strategy)
    assert w.bytes == n * f * 4 + 3 * n * 4
    hist = 2 * n * f
    search = 12 * 32 * f * 51
    base = 8 * n + n * f * math.ceil(math.log2(51)) + depth * (
        hist + search + n)
    prop = (f * k * math.log2(k) if strategy == "random"
            else n * f * (math.log2(n) + 1))
    assert w.ops == pytest.approx(base + prop)
    # a round is bound by its bytes: 0.62 GB over 3.35 TB/s
    assert counts.least_seconds(w) == pytest.approx(w.bytes / 3.35e12)


def test_fit_round_wiretap_search_path():
    (n, f, k), depth = _shape(WIRETAP), 6
    assert (n, f, k) == (2_050_820, 115, 255)
    w = counts.fit_round(n, f, k, depth, "random")
    assert w.bytes == n * f * 4 + 3 * n * 4
    assert counts.least_seconds(w) == pytest.approx(
        max(w.bytes / 3.35e12, w.ops / 67e12))


def test_forest_request_batch1m():
    w = counts.forest_request(1_000_000, 28, 500, 6)
    assert w.bytes == 1_000_000 * 28 * 4 + 4_000_000 + 500 * (63 * 5 + 64 * 4)
    assert w.ops == 1_000_000 * 500 * 7 + 2_000_000
    # a request is bound by its compares: 3.502e9 over 67 TFLOP/s
    assert counts.least_seconds(w) == pytest.approx(w.ops / 67e12)


def test_unknown_strategy_has_no_count():
    with pytest.raises(ValueError):
        counts.proposal(10, 2, 4, "gk_quantile")


def _fit_run(measured_scale: float) -> workloads.Run:
    """A traced fit run whose every timing is ``measured_scale`` times the
    counted least time."""
    n, f, k = _shape(HIGGS)
    run = workloads.Run(kind="fit", rounds=20, traced_rounds=20)
    run.work = {"round": counts.fit_round(n, f, k, 6, "random"),
                "hist_tree": counts.hist_tree(n, f, k + 1, 6)}
    round_s = counts.least_seconds(run.work["round"]) * measured_scale
    run.fit_seconds = [20 * round_s] * 3
    acts = [Activity("hist_kernel", counts.least_seconds(w) * measured_scale,
                     ("kernels/hist.py", "core/tree.py"))
            for _ in range(20) for w in run.work["hist_tree"]]
    run.trace = Trace(window_s=1.0, busy_s=0.5, activities=acts,
                      idle_by_host={})
    return run


def _score_run(measured_scale: float) -> workloads.Run:
    run = workloads.Run(kind="score")
    run.work = {"request": counts.forest_request(1_000_000, 28, 500, 6)}
    req_s = counts.least_seconds(run.work["request"]) * measured_scale
    run.latencies = [req_s] * 10
    run.window_s, run.window_rows = 10 * req_s, 10_000_000
    run.trace = Trace(window_s=4 * req_s, busy_s=4 * req_s, activities=[
        Activity("void forest_sum_kernel<float, true>(...)", req_s,
                 ("kernels/traverse.py", "core/predict.py"))] * 4,
        idle_by_host={})
    return run


@pytest.mark.parametrize("name,make", [
    ("hist_roofline_pct", _fit_run), ("fit_round_mfu", _fit_run),
    ("forest_sum_roofline_pct", _score_run), ("score_mfu", _score_run)])
def test_no_share_passes_100_at_the_counted_time(name, make):
    read = harness.reader(name)
    assert read(make(1.0)) == pytest.approx(100.0)
    assert read(make(1.0)) <= 100.0 + 1e-9
    assert read(make(4.0)) == pytest.approx(25.0)


def test_shares_are_silent_without_a_reading():
    empty = workloads.Run(kind="fit")
    for name in ("hist_roofline_pct", "fit_round_mfu", "propose_ms",
                 "bin_ms", "grow_ms", "idle_pct.fit"):
        assert harness.reader(name)(empty) is None
    assert counts.share_pct(1.0, 0.0) is None
