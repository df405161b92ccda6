"""The plain reference against the port's CPU path at a small size, and
the control and every planted fault judged not correct, each by a whole
run of the harness but for its look for a card, held to the cell's own
limits.

On the CPU the port sums its histograms and leaves in float32 in row
order: at a few thousand rows a leaf lies up to about 2.5e-5 from the
float64 reference (the card's fixed-point sums, up to 9e-6 at 5M rows).
"""

import copy
import time

import pytest
import torch

from bench_h100 import compare, faults, harness, reference, synth, workloads

FITS = ("higgs.fit.random.k50", "wiretap.fit.random.k255",
        "higgs.fit.quantile.k50")


def tiny(workload: str) -> dict:
    """The cell's files at a size a test run holds."""
    cell = harness.load_cell(workload)
    cell["config"].update(rows=3000, train_rows=2500, features=6)
    cell["config"]["model"].update(n_trees=4, max_depth=3)
    if cell["traffic"]["kind"] == "score":
        cell["traffic"]["forest"].update(n_trees=30, max_depth=4)
        cell["traffic"].update(rows_per_request=400, max_requests=50,
                               check={"requests": 3})
    return cell


def run(cell: dict, seed: int) -> tuple[dict, workloads.Run]:
    """A whole run of ``cell`` on the CPU but for the look for a card:
    the result line the harness would print, and the run.  (The modules
    that the harness finds loaded are not asked about here: other test
    files of this process load JAX; ``test_bench_h100_contract`` asks in
    a process of its own.)"""
    result, r, _ = harness.measure(copy.deepcopy(cell), seed, 0.0, False,
                                   "cpu", time.perf_counter(), lambda: 0)
    return result, r


@pytest.mark.parametrize("workload", [*FITS, "higgs.score.batch1m"])
@pytest.mark.parametrize("seed", [3, 2 ** 31 + 11])
def test_port_cpu_path_agrees_with_the_reference(workload, seed):
    cell = tiny(workload)
    result, r = run(cell, seed)
    assert result["correct"] is True, r.numbers
    assert result["attempted"] >= 1 and result["failed"] == 0
    for key in ("cand_bad", "thresh_bad"):
        assert r.numbers.get(key, 0) == 0
    assert {m["name"] for m in cell["end_to_end"]} == set(result["metrics"])


@pytest.mark.parametrize("workload", [*FITS, "higgs.score.batch1m"])
def test_control_is_not_correct(workload):
    cell = tiny(workload)
    numbers = workloads.control_numbers(cell, 5, "cpu")
    assert set(numbers) == set(cell["limits"])
    assert not compare.held(numbers, cell["limits"]), numbers


@pytest.mark.parametrize("workload,fault", [
    *((w, f) for w in FITS for f in faults.FIT),
    *(("higgs.score.batch1m", f) for f in faults.SCORE)])
def test_planted_fault_is_not_correct(workload, fault):
    cell = tiny(workload)
    with faults.planted(cell["traffic"]["kind"], fault):
        result, r = run(cell, 7)
    assert result["correct"] is False, r.numbers
    assert result["failed"] >= 1


def test_faults_restore_the_program():
    from repro_torch.core import boosting, proposal, tree
    from repro_torch.kernels import ops
    before = (boosting.grad_hess, ops.hist_levels, ops.leaf_sums,
              tree.build_tree, ops.forest_sum, proposal.propose)
    for kind, names in (("fit", faults.FIT), ("score", faults.SCORE)):
        for name in names:
            with faults.planted(kind, name):
                pass
    assert before == (boosting.grad_hess, ops.hist_levels, ops.leaf_sums,
                      tree.build_tree, ops.forest_sum, proposal.propose)


def test_reference_fit_float64_judged_exact():
    """The reference's own float64 fit, judged by the comparison: exact
    but for its leaves, kept as float32 (within 2^-24 of their value)."""
    cell = tiny("higgs.fit.quantile.k50")
    c = cell["config"]
    x, y = synth.classification(c["train_rows"], c["features"], 9, "cpu")
    fitted = reference.fit(x, y, c["model"], strategy="weighted_quantile",
                           k=cell["traffic"]["n_candidates"], generator=None,
                           dtype=torch.float64)
    numbers, _ = compare.fit_numbers(x, y, fitted, c["model"],
                                     strategy="weighted_quantile",
                                     k=cell["traffic"]["n_candidates"],
                                     repropose=True)
    assert numbers["cand_bad"] == 0 and numbers["thresh_bad"] == 0
    assert numbers["grid_repeat"] == 0
    assert numbers["split_gap"] == 0.0
    assert numbers["leaf_gap"] < 2 ** -23
    assert numbers["cand_rank_gap"] < 1e-12


def test_score_reference_equals_per_tree_sum():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((50, 5), generator=g)
    arrays = {"forest/feature": torch.tensor([[0, -1, 2], [4, 1, -1]]),
              "forest/threshold": torch.tensor(
                  [[0.1, float("inf"), -0.3], [0.0, 0.5, float("inf")]]),
              "forest/leaf_value": torch.arange(8.0).reshape(2, 4)}
    got = reference.margins(x, arrays["forest/feature"],
                            arrays["forest/threshold"],
                            arrays["forest/leaf_value"], base=0.5,
                            learning_rate=0.1, depth=2, dtype=torch.float64)
    want = torch.zeros(50, dtype=torch.float64)
    for t in range(2):
        for i in range(50):
            node = 0
            for d in range(2):
                heap = 2 ** d - 1 + node
                feat = int(arrays["forest/feature"][t, heap])
                go = x[i, max(feat, 0)] <= arrays["forest/threshold"][t, heap]
                node = 2 * node + (0 if go else 1)
            want[i] += float(arrays["forest/leaf_value"][t, node])
    assert torch.allclose(got, 0.5 + 0.1 * want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("nbins", [51, 256])
@pytest.mark.parametrize("seed", range(4))
def test_gain_rounding_bounds_the_programs_float32_gain(nbins, seed):
    """Gains worked out as the program does (exact buckets rounded to
    float32, float32 prefix sums, ``GR = G - GL``, a float32 gain) lie
    within ``compare._gain_rounding`` of the exact gains, on nodes of
    millions of rows with a side of a few rows."""
    g = torch.Generator().manual_seed(seed)
    rows = torch.randint(1, 200_000, (8, 3, nbins), generator=g)
    rows[:, :, -1] = torch.randint(1, 40, (8, 3), generator=g)
    H = rows * (0.05 + 0.2 * torch.rand(rows.shape, generator=g,
                                         dtype=torch.float64))
    G = rows * 0.3 * torch.randn(rows.shape, generator=g,
                                 dtype=torch.float64)
    gain, _, HL, HR = reference.split_gains(G, H, l2=1.0, gamma=0.0,
                                            min_child_weight=1.0)
    unc, uH = compare._gain_rounding(G, H, HL, HR, 1.0)
    Gf, Hf = G.float(), H.float()
    GLf, HLf = torch.cumsum(Gf, 2)[..., :-1], torch.cumsum(Hf, 2)[..., :-1]
    Gt, Ht = GLf[..., -1:] + Gf[..., -1:], HLf[..., -1:] + Hf[..., -1:]
    GRf, HRf = Gt - GLf, Ht - HLf
    gain32 = 0.5 * (GLf * GLf / (HLf + 1) + GRf * GRf / (HRf + 1)
                    - Gt * Gt / (Ht + 1))
    assert ((gain32.double() - gain).abs() <= unc).all()
    assert ((HRf.double() - HR).abs() <= uH).all()
    assert ((HLf.double() - HL).abs() <= uH).all()
