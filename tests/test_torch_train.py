"""Parity of the port's training path with the JAX package's.

The same numpy inputs go through both on the CPU.  Contracts, with their
reasons:

  * direct ``build_tree`` is bit-equal to the JAX ``build_tree``
    (backend ``ref``) on the same bins, g/h and candidates: trees, leaf
    ids, leaf values and ``TreeStats``;
  * subtraction growth keeps a bucket that holds no rows exactly zero
    (child mode counts each bucket's rows), where the JAX package's
    ``parent - left`` can leave a rounding residue (in a right child of
    a right child).  So the port's subtraction tree is the JAX
    subtraction tree, except where that residue moves a split: there
    the port takes the split of direct growth, which sees an exact zero.
    On the two inputs of the JAX tests below the trees and leaf ids are
    bit-equal to JAX subtraction growth, and the realized gains
    (``gain_sum``, ``gain_max``) within rtol 1e-5, the residue moving
    them in their last bits; ``test_subtract_takes_direct_growth_split_
    where_jax_leaves_a_residue`` shows an input where the residue moves
    a split;
  * subtraction growth does not depend on the order in which a
    histogram's adds run (the card's atomics have none): with sums in
    shuffled orders its trees are the row-order trees;
  * ``fit`` against the JAX ``boosting.fit`` on the pinned ``_toy``
    workloads of tests/test_scan_trainer.py, fed the JAX model's own
    candidate grids (the RNG streams differ): structure exact, thresholds
    within 1e-6, leaves within 1e-5 (``_assert_forests_match``), margins
    within 1e-5.  Not bit for bit, for two reasons: ``torch.sigmoid`` and
    ``jax.nn.sigmoid`` round 1 ulp apart in places, and XLA:CPU contracts
    the compiled round step's ``margin + lr * leaf`` into a fused
    multiply-add, where the port (like the JAX package's eager ops)
    rounds twice;
  * with ``objective='mse'`` there is no sigmoid, so the port is bit-equal
    to a JAX round loop of eager ops, and to the compiled JAX ``fit``
    for its first tree, before any margin update.

``fit_reference`` is not used: eager ``propose`` fails on jax 0.9.0.
"""

import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro_torch
from repro.core import binning as jbinning, boosting as jboosting
from repro.core import proposal as jproposal, tree as jtree
from repro.data import tabular as jtabular
from repro.kernels.ops import HistSpec as JHistSpec
from repro_torch.core import boosting, proposal, tree
from repro_torch.data import tabular
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ops import HistSpec


def _toy(n=4000, f=6, seed=0):
    """The pinned workload of tests/test_scan_trainer.py."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, f))
    w = jax.random.normal(jax.random.fold_in(key, 1), (f,))
    y = (x @ w > 0).astype(jnp.float32)
    return np.array(x), np.array(y)


def _assert_forests_match(fa, fb):
    """tests/test_scan_trainer.py's contract; ``fb`` is the port's."""
    np.testing.assert_array_equal(np.asarray(fa.feature), fb.feature.numpy())
    np.testing.assert_array_equal(np.asarray(fa.split_bin),
                                  fb.split_bin.numpy())
    np.testing.assert_allclose(np.asarray(fa.threshold),
                               fb.threshold.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(fa.leaf_value),
                               fb.leaf_value.numpy(), atol=1e-5)


def _assert_forests_equal(fa, fb):
    for a, b in zip(fa, fb):
        assert np.array_equal(np.asarray(a), b.numpy())


# -- build_tree --------------------------------------------------------------

def _grow_both(bins, gh, cand, depth, subtract):
    nbins = cand.shape[1] + 1
    kw = dict(n_nodes=2 ** max(depth - 1, 0), nbins=nbins,
              n_levels=max(depth, 1), subtract=subtract)
    jt, jn, js = jtree.build_tree(
        jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(cand),
        max_depth=depth, spec=JHistSpec(backend="ref", **kw),
        return_leaf_nodes=True, return_stats=True)
    tt, tn, ts = tree.build_tree(
        torch.from_numpy(bins), torch.from_numpy(gh), torch.from_numpy(cand),
        max_depth=depth, spec=HistSpec(**kw), return_leaf_nodes=True,
        return_stats=True)
    return (jt, jn, js), (tt, tn, ts)


def _assert_grown_equal(j, t, subtract):
    (jt, jn, js), (tt, tn, ts) = j, t
    _assert_forests_equal(jt, tt)
    assert np.array_equal(np.asarray(jn), tn.numpy())
    exact = ("n_splits", "hist_updates") if subtract else js._fields
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        if name in exact:
            assert np.array_equal(a, b), (name, js, ts)
        else:
            np.testing.assert_allclose(b, a, rtol=1e-5, err_msg=name)


@pytest.fixture(scope="module")
def hist_levels_case():
    """The inputs of tests/test_hist_levels.py:175."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(600, 4)).astype(np.float32)
    cand = np.sort(rng.normal(size=(4, 8)).astype(np.float32), 1)
    bins = np.asarray(jbinning.bin_features(jnp.asarray(x),
                                            jnp.asarray(cand)))
    gh = rng.normal(size=(600, 2)).astype(np.float32)
    gh[:, 1] = np.abs(gh[:, 1]) + 0.1
    return bins, gh, cand


@pytest.fixture(scope="module")
def telemetry_case():
    """The inputs of tests/test_telemetry.py:137, with the grid drawn by
    ``random_candidates`` directly (eager ``propose`` fails on jax
    0.9.0)."""
    key = jax.random.PRNGKey(5)
    x = jax.random.normal(key, (800, 4))
    w = jax.random.normal(jax.random.fold_in(key, 1), (4,))
    y = (x @ w > 0).astype(jnp.float32)
    c = jproposal.random_candidates(jax.random.PRNGKey(1), x, 8)
    bins = jbinning.bin_features(x, c)
    g, h = jboosting.grad_hess(jnp.zeros(x.shape[0]), y, "logistic")
    return (np.asarray(bins), np.asarray(jnp.stack([g, h], 1)),
            np.asarray(c))


@pytest.mark.parametrize("subtract", [False, True],
                         ids=["direct", "subtract"])
@pytest.mark.parametrize("depth", [0, 1, 2, 4, 6])
@pytest.mark.parametrize("case", ["hist_levels_case", "telemetry_case"])
def test_build_tree_bit_equal(request, case, depth, subtract):
    bins, gh, cand = request.getfixturevalue(case)
    j, t = _grow_both(bins, gh, cand, depth, subtract)
    _assert_grown_equal(j, t, subtract)
    assert t[1].dtype == torch.int32


def test_subtract_takes_direct_growth_split_where_jax_leaves_a_residue():
    """On these rows JAX subtraction growth splits heap node 10 (a right
    child of a right child) on the residue of ``parent - left`` in a
    bucket with no rows: a positive gain that sends every row of the node
    to one side.  Direct growth sees an exact zero there and leaves the
    node a passthrough; so does the port's subtraction growth, whose tree
    is the direct-growth tree bit for bit."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(400, 3)).astype(np.float32)
    cand = np.sort(rng.normal(size=(3, 8)).astype(np.float32), 1)
    bins = np.asarray(jbinning.bin_features(jnp.asarray(x),
                                            jnp.asarray(cand)))
    gh = rng.normal(size=(400, 2)).astype(np.float32)
    gh[:, 1] = np.abs(gh[:, 1]) + 0.1
    (jd, jd_node, _), (td, td_node, _) = _grow_both(bins, gh, cand, 4, False)
    (js, js_node, _), (ts, ts_node, _) = _grow_both(bins, gh, cand, 4, True)
    _assert_forests_equal(jd, td)
    # JAX subtraction growth: node 10 splits, and its left leaf is empty
    assert int(js.feature[10]) >= 0 and int(jd.feature[10]) == -1
    assert not (np.asarray(js_node) == 6).any()
    # the port's subtraction growth: the direct-growth tree and leaf ids
    _assert_forests_equal(jd, ts)
    assert np.array_equal(np.asarray(jd_node), ts_node.numpy())
    # elsewhere the two JAX trees agree
    others = np.arange(15) != 10
    assert np.array_equal(np.asarray(js.feature)[others],
                          np.asarray(jd.feature)[others])


def _shuffled_sums(seed):
    """``ref.hist_levels_ref`` adding the rows in a fresh random order on
    every call, as atomics do."""
    gen = torch.Generator().manual_seed(seed)
    plain = ref.hist_levels_ref

    def hist_levels_ref(bins, node_per_level, gh, *, n_nodes, nbins):
        perm = torch.randperm(bins.shape[0], generator=gen)
        return plain(bins[perm], node_per_level[:, perm], gh[perm],
                     n_nodes=n_nodes, nbins=nbins)
    return hist_levels_ref


def test_subtract_growth_ignores_the_order_of_adds(monkeypatch):
    """On this fit a right child has an empty bin beside its best one: an
    exact tie, which the first bin wins.  Summed in other orders,
    ``parent - left`` of the same rows left a residue there and moved the
    split one bin to the right (the card did so in 2 of 12 fits); the
    port keeps empty buckets exactly zero."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    grid = torch.stack([proposal.random_candidates(
        gen, torch.from_numpy(x), 16) for _ in range(6)])
    cfg = repro_torch.GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                                 subtract=True)
    want = repro_torch.fit(x, y, cfg, candidates=grid, device="cpu").forest
    direct = repro_torch.fit(x, y, dataclasses.replace(cfg, subtract=False),
                             candidates=grid, device="cpu").forest
    for a, b in zip(want[:3], direct[:3]):       # structure and thresholds
        assert torch.equal(a, b)
    for seed in range(8):
        monkeypatch.setattr(ref, "hist_levels_ref", _shuffled_sums(seed))
        got = repro_torch.fit(x, y, cfg, candidates=grid,
                              device="cpu").forest
        monkeypatch.undo()
        for a, b in zip(got[:3], want[:3]):
            assert torch.equal(a, b), seed
        torch.testing.assert_close(got.leaf_value, want.leaf_value,
                                   rtol=0, atol=1e-6)


def test_build_tree_stats_count_updates(telemetry_case):
    """Direct growth adds every row at every level, subtraction growth
    only the rows routed left."""
    bins, gh, cand = telemetry_case
    _, (tt, _, ts) = _grow_both(bins, gh, cand, 4, False)
    assert float(ts.hist_updates) == 800 * 4 * 4
    assert int(ts.n_splits) == int((tt.feature >= 0).sum())
    _, (_, _, ts_sub) = _grow_both(bins, gh, cand, 4, True)
    assert float(ts_sub.hist_updates) < float(ts.hist_updates)


def test_build_tree_needs_the_frontier(hist_levels_case):
    bins, gh, cand = (torch.from_numpy(a) for a in hist_levels_case)
    with pytest.raises(ValueError, match="frontier"):
        tree.build_tree(bins, gh, cand, max_depth=4,
                        spec=HistSpec(n_nodes=4, nbins=9))


@pytest.mark.parametrize("depth", [1, 4, 6])
@pytest.mark.parametrize("case", ["hist_levels_case", "telemetry_case"])
def test_leaf_sums_ref_path_is_build_trees_leaves(request, case, depth):
    """``ops.leaf_sums`` on the CPU is the row-order ``index_add_`` that
    ``build_tree`` had inline: its leaves, bit for bit."""
    bins, gh, cand = (torch.from_numpy(a) for a in
                      request.getfixturevalue(case))
    spec = HistSpec(n_nodes=2 ** (depth - 1), nbins=cand.shape[1] + 1)
    t, node = tree.build_tree(bins, gh, cand, max_depth=depth, spec=spec,
                              return_leaf_nodes=True)
    seg = torch.zeros((2 ** depth, 2))
    seg.index_add_(0, node.long(), gh)
    got = ops.leaf_sums(node, gh, 2 ** depth)
    assert torch.equal(got, seg)
    assert torch.equal(ops.leaf_sums(node, gh, 2 ** depth, backend="ref"),
                       seg)
    assert torch.equal(t.leaf_value, -got[:, 0] / (got[:, 1] + 1.0))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.leaf_sums(node, gh, 2 ** depth, backend="cuda")


@pytest.mark.parametrize("case", ["hist_levels_case", "telemetry_case"])
def test_leaf_sums_fixed_point_path(request, case):
    """The card's path (``ref.fixed_point_sums``, run here on the CPU):
    leaves within 1e-5 of the row-order ones (the leaf contract), sums
    within the histogram's restated rounding bound (a leaf is a one-bin
    histogram), and the same bits in any order of the rows."""
    bins, gh, cand = (torch.from_numpy(a) for a in
                      request.getfixturevalue(case))
    spec = HistSpec(n_nodes=8, nbins=cand.shape[1] + 1)
    _, node = tree.build_tree(bins, gh, cand, max_depth=4, spec=spec,
                              return_leaf_nodes=True)
    want = ops.leaf_sums(node, gh, 16, backend="ref")
    got = ref.fixed_point_sums(node, gh, 16)
    bound = ref.hist_rounding_bound(
        torch.zeros((node.shape[0], 1), dtype=torch.int32), node[None], gh,
        n_nodes=16, nbins=1, quantum=ref.hist_quanta(gh))
    assert bool(((got.double() - want.double()).abs()
                 <= bound.reshape(16, 2)).all())
    torch.testing.assert_close(-got[:, 0] / (got[:, 1] + 1.0),
                               -want[:, 0] / (want[:, 1] + 1.0),
                               rtol=0, atol=1e-5)
    for seed in range(4):
        perm = torch.randperm(node.shape[0],
                              generator=torch.Generator().manual_seed(seed))
        assert torch.equal(ref.fixed_point_sums(node[perm], gh[perm], 16),
                           got)


@pytest.mark.parametrize("subtract", [False, True],
                         ids=["direct", "subtract"])
def test_fixed_point_fit_keeps_the_restated_leaf_contract(monkeypatch,
                                                          subtract):
    """The card's arithmetic (fixed-point histograms and leaf sums), run
    here on the CPU, on chip_smoke's 4000 x 6 train_check workload: the
    CPU fit's trees, structure exact; its leaves lie within 1.6e-7 of
    their exact (float64) sums, where the CPU's row-order float32 sums
    lie up to 1.4e-5 away.  So the card is held to the CPU's leaves
    within 1e-5 beyond the CPU's own rounding."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4000, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    gen = torch.Generator().manual_seed(0)
    grid = torch.stack([proposal.random_candidates(
        gen, torch.from_numpy(x), 16) for _ in range(6)])
    cfg = repro_torch.GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                                 subtract=subtract)
    cpu = repro_torch.fit(x, y, cfg, candidates=grid, device="cpu")
    monkeypatch.setattr(ref, "hist_levels_ref", functools.partial(
        ref.hist_levels_fixed, child=False))
    monkeypatch.setattr(ref, "hist_levels_left_ref", functools.partial(
        ref.hist_levels_fixed, child=True))
    monkeypatch.setattr(ops, "leaf_sums", lambda node, gh, n, backend:
                        ref.fixed_point_sums(node, gh, n))
    fixed = repro_torch.fit(x, y, cfg, candidates=grid, device="cpu")
    monkeypatch.undo()
    for a, b in zip(fixed.forest[:3], cpu.forest[:3]):
        assert torch.equal(a, b)
    cpu_rounding = boosting.leaf_rounding(cpu, x, y)
    assert float(cpu_rounding.max()) > 1e-5        # why it is restated
    assert float(boosting.leaf_rounding(fixed, x, y).max()) <= 1e-6
    diff = (fixed.forest.leaf_value - cpu.forest.leaf_value).abs().double()
    assert bool((diff <= 1e-5 + cpu_rounding).all())


def test_leaf_rounding_replays_the_fit():
    """``leaf_rounding`` replays a fit's rounds: one value a leaf, small
    for float32 sums of 1000 rows, and 0 at an empty leaf (0 on both
    sides)."""
    x, y = _toy(1000, 4, 2)
    cfg = repro_torch.GBDTConfig(n_trees=3, max_depth=3, n_candidates=8)
    model = repro_torch.fit(x, y, cfg, device="cpu")
    r = boosting.leaf_rounding(model, x, y)
    assert r.shape == (3, 8) and r.dtype == torch.float64
    assert float(r.max()) < 1e-4
    empty = model.forest.leaf_value == 0
    assert bool((r[empty] == 0).all())


# -- fit ---------------------------------------------------------------------

PINNED = {  # name: (_toy args, key, config) of tests/test_scan_trainer.py
    "random": ((), 3, dict(n_trees=6, max_depth=4, n_candidates=16)),
    "subtract": ((), 3, dict(n_trees=6, max_depth=4, n_candidates=16,
                             subtract=True)),
    "no_repropose": ((4000, 6, 2), 1, dict(n_trees=5, max_depth=4,
                                           n_candidates=16,
                                           repropose_each_round=False)),
    "depth_one": ((1000, 4, 9), 2, dict(n_trees=3, max_depth=1,
                                        n_candidates=8, subtract=True)),
}


@pytest.fixture(scope="module", params=sorted(PINNED))
def pinned(request):
    toy_args, key, kw = PINNED[request.param]
    x, y = _toy(*toy_args)
    jm = jboosting.fit(x, y, jboosting.GBDTConfig(**kw),
                       jax.random.PRNGKey(key))
    tm = repro_torch.fit(x, y, repro_torch.GBDTConfig(**kw),
                         candidates=np.asarray(jm.candidates), device="cpu")
    return x, y, jm, tm


def test_fit_matches_jax_fit(pinned):
    x, _, jm, tm = pinned
    _assert_forests_match(jm.forest, tm.forest)
    assert np.array_equal(np.asarray(jm.candidates), tm.candidates.numpy())
    assert tm.base_score == jm.base_score
    want = np.asarray(jm.predict(jnp.asarray(x), output="margin"))
    got = tm.predict(x, output="margin").numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_fit_model_fields(pinned):
    _, _, jm, tm = pinned
    assert tm.config == repro_torch.GBDTConfig(
        **dataclasses.asdict(jm.config))
    assert tm.candidates.shape == jm.candidates.shape
    assert tm.fit_seconds > 0.0 and tm.proposal_seconds == 0.0
    assert len(tm.trees) == tm.config.n_trees


def test_port_trained_model_serves_in_jax(pinned, tmp_path):
    """A port-trained model crosses to the JAX package through a
    checkpoint and predicts there bit for bit as in the port."""
    from repro.checkpoint import load_gbdt as jload
    x, _, _, tm = pinned
    path = repro_torch.save_gbdt(str(tmp_path / "m.npz"), tm)
    jm = jload(path)
    assert np.array_equal(np.asarray(jm.predict(jnp.asarray(x),
                                                output="margin")),
                          tm.predict(x, output="margin").numpy())


def _jax_eager_loop(x, y, cfg, cands):
    """The JAX package's round step as eager ops (two roundings in the
    margin update), on an injected grid."""
    spec = JHistSpec(n_nodes=2 ** max(cfg.max_depth - 1, 0), nbins=cfg.nbins,
                     n_levels=max(cfg.max_depth, 1), backend="ref",
                     subtract=cfg.subtract)
    x, y = jnp.asarray(x), jnp.asarray(y)
    margin = jnp.full((x.shape[0],), jboosting._base_score(y, cfg.objective),
                      jnp.float32)
    trees = []
    for r in range(cfg.n_trees):
        c = jnp.asarray(cands[min(r, cands.shape[0] - 1)])
        bins = jbinning.bin_features(x, c)
        g, h = jboosting.grad_hess(margin, y, cfg.objective)
        t, node = jtree.build_tree(
            bins, jnp.stack([g, h], 1), c, max_depth=cfg.max_depth,
            l2=cfg.l2, gamma=cfg.gamma,
            min_child_weight=cfg.min_child_weight, spec=spec,
            return_leaf_nodes=True)
        margin = margin + cfg.learning_rate * t.leaf_value[node]
        trees.append(t)
    return jtree.forest_from_trees(trees)


@pytest.mark.parametrize("subtract", [False, True],
                         ids=["direct", "subtract"])
def test_fit_mse_bit_equal(subtract):
    x, y = _toy()
    kw = dict(n_trees=6, max_depth=4, n_candidates=16, objective="mse",
              subtract=subtract)
    jm = jboosting.fit(x, y, jboosting.GBDTConfig(**kw),
                       jax.random.PRNGKey(3))
    tm = repro_torch.fit(x, y, repro_torch.GBDTConfig(**kw),
                         candidates=np.asarray(jm.candidates), device="cpu")
    forest = _jax_eager_loop(x, y, jboosting.GBDTConfig(**kw),
                             np.asarray(jm.candidates))
    _assert_forests_equal(forest, tm.forest)
    # the compiled JAX fit agrees bit for bit up to its first margin update
    _assert_forests_equal(jtree.Forest(*(a[:1] for a in jm.forest)),
                          tree.Forest(*(a[:1] for a in tm.forest)))
    _assert_forests_match(jm.forest, tm.forest)


def test_fit_raises_on_what_is_not_ported():
    x, y = _toy(200, 3)
    with pytest.raises(NotImplementedError, match="queue 1 item 2"):
        repro_torch.fit(x, y, repro_torch.GBDTConfig(
            strategy="weighted_quantile"), device="cpu")
    with pytest.raises(NotImplementedError, match="item 3"):
        repro_torch.fit(x, y, repro_torch.GBDTConfig(telemetry=True),
                        device="cpu")
    with pytest.raises(ValueError, match="candidates must have shape"):
        repro_torch.fit(x, y, repro_torch.GBDTConfig(n_trees=2),
                        candidates=np.zeros((1, 3, 32), np.float32),
                        device="cpu")


def test_fit_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    x, y = _toy(200, 3)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        repro_torch.fit(x, y, repro_torch.GBDTConfig(n_trees=1))


@pytest.mark.parametrize("repropose", [True, False])
def test_fit_proposes_from_a_generator(repropose):
    """Without an injected grid, ``fit`` draws one per round (or once)
    from the generator: a seeded generator repeats the model."""
    x, y = _toy(1000, 4)
    cfg = repro_torch.GBDTConfig(n_trees=3, max_depth=3, n_candidates=8,
                                 repropose_each_round=repropose)
    a = repro_torch.fit(x, y, cfg, torch.Generator().manual_seed(7),
                        device="cpu")
    b = repro_torch.fit(x, y, cfg, torch.Generator().manual_seed(7),
                        device="cpu")
    assert a.candidates.shape == ((3 if repropose else 1), 4, 8)
    for u, v in zip(a.forest, b.forest):
        assert torch.equal(u, v)
    assert repro_torch.accuracy(a, x, y) > 0.8


def test_fit_mse_mape_runs():
    x, y = jtabular.friedman1(2000, 10, seed=0)
    cfg = repro_torch.GBDTConfig(n_trees=5, max_depth=3, n_candidates=16,
                                 objective="mse")
    m = repro_torch.fit(x, y, cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    assert np.isfinite(repro_torch.mape(m, x, y))


def test_grad_hess_and_base_score_match():
    x, y = _toy(500, 3)
    margin = np.random.default_rng(0).normal(size=500).astype(np.float32)
    for obj in ("logistic", "mse"):
        jg, jh = jboosting.grad_hess(jnp.asarray(margin), jnp.asarray(y), obj)
        tg, th = boosting.grad_hess(torch.from_numpy(margin),
                                    torch.from_numpy(y), obj)
        if obj == "mse":
            assert np.array_equal(tg.numpy(), np.asarray(jg))
            assert np.array_equal(th.numpy(), np.asarray(jh))
        else:   # sigmoid rounds 1 ulp apart in places
            np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-7)
            np.testing.assert_allclose(th.numpy(), np.asarray(jh), atol=1e-7)
        assert boosting._base_score(torch.from_numpy(y), obj) == \
            jboosting._base_score(jnp.asarray(y), obj)
    with pytest.raises(ValueError):
        boosting.grad_hess(torch.zeros(3), torch.zeros(3), "huber")


def test_hist_spec_matches_jax():
    for kw in (dict(), dict(max_depth=1, subtract=True),
               dict(max_depth=0, n_candidates=8)):
        js = jboosting.GBDTConfig(**kw).hist_spec()
        ts = boosting.GBDTConfig(**kw).hist_spec()
        assert (ts.n_nodes, ts.nbins, ts.n_levels, ts.subtract) == \
            (js.n_nodes, js.nbins, js.n_levels, js.subtract)


# -- proposal ----------------------------------------------------------------

@pytest.mark.parametrize("n,f,k", [(1, 1, 4), (50, 3, 8), (1000, 6, 32)])
def test_random_candidates_properties(n, f, k):
    x = torch.from_numpy(np.random.default_rng(n).normal(
        size=(n, f)).astype(np.float32))
    c = proposal.random_candidates(torch.Generator().manual_seed(1), x, k)
    assert c.shape == (f, k) and c.dtype == torch.float32
    assert bool((c[:, 1:] >= c[:, :-1]).all())           # sorted
    for j in range(f):                                  # drawn from column j
        assert bool(torch.isin(c[j], x[:, j]).all())
    again = proposal.random_candidates(torch.Generator().manual_seed(1), x, k)
    assert torch.equal(c, again)
    other = proposal.random_candidates(torch.Generator().manual_seed(2), x, k)
    assert n == 1 or not torch.equal(c, other)
    assert torch.equal(proposal.random_candidates_local(
        torch.Generator().manual_seed(1), x, k), c)


def test_resample_gathered_properties():
    gathered = torch.from_numpy(np.random.default_rng(0).normal(
        size=(4, 3, 8)).astype(np.float32))
    c = proposal.resample_gathered(torch.Generator().manual_seed(3),
                                   gathered, 8)
    assert c.shape == (3, 8)
    assert bool((c[:, 1:] >= c[:, :-1]).all())
    for j in range(3):
        assert bool(torch.isin(c[j], gathered[:, j].reshape(-1)).all())
    assert torch.equal(c, proposal.resample_gathered(
        torch.Generator().manual_seed(3), gathered, 8))
    assert proposal.TRACEABLE == jproposal.TRACEABLE


# -- data --------------------------------------------------------------------

@pytest.mark.parametrize("name", jtabular.DATASET_NAMES)
def test_tabular_copy_matches(name):
    a = jtabular.make_dataset(name, 300, 50, seed=4)
    b = tabular.make_dataset(name, 300, 50, seed=4)
    assert a[4] == b[4]
    for u, v in zip(a[:4], b[:4]):
        assert np.array_equal(u, v)
