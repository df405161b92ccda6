"""Parity of the port's serving path with the JAX package's.

The same numpy inputs go through the JAX engine and the port on the
CPU.  Contracts, with their reasons:

  * margins and ensemble sums: bit-identical (``np.array_equal``), raw
    and binned, NaN rows included -- traversal is pure selects and the
    sum is the same float32 adds in the same (tree) order;
  * bin ids: integer-exact for k = 8 and 32 (dense count) and k = 100
    (searchsorted), NaN rows in the last bin;
  * ``proba``: atol 1e-7, rtol 1e-6, since ``torch.sigmoid`` and
    ``jax.nn.sigmoid`` may round differently; ``label``: equal wherever
    ``|margin| > 1e-6``.

Covers the pinned 13 x 4 x 6 fixture of tests/test_predict_engine.py and
a model trained by ``repro.fit`` (the ``_toy`` workload of
tests/test_scan_trainer.py), carried across with ``model_from_numpy``
and through checkpoints in both directions.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
import repro_torch
from repro.core import binning as jbinning, predict as jpredict
from repro.core import tree as jtree
from repro.kernels.ops import TraverseSpec as JTraverseSpec
from repro.launch.serve_gbdt import synthetic_gbdt
from repro_torch.core import binning, predict, tree

N_TREES, DEPTH, F, K = 13, 4, 6, 8


def _arrays(jm):
    """A JAX model's parameters as numpy, keyed as in its checkpoint."""
    out = {f"forest/{k}": np.asarray(getattr(jm.forest, k))
           for k in ("feature", "split_bin", "threshold", "leaf_value")}
    out["candidates"] = np.asarray(jm.candidates)
    return out


def _carry(jm):
    return repro_torch.model_from_numpy(
        _arrays(jm), dataclasses.asdict(jm.config), jm.base_score,
        device="cpu")


@pytest.fixture(scope="module")
def jmodel():
    return synthetic_gbdt(n_trees=N_TREES, max_depth=DEPTH, n_features=F,
                          n_candidates=K, seed=7, passthrough_frac=0.25)


@pytest.fixture(scope="module")
def tmodel(jmodel):
    return _carry(jmodel)


@pytest.fixture(scope="module")
def x_nan():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(97, F)).astype(np.float32)
    x[::11, 0] = np.nan
    x[5, :] = np.nan
    return x


def _toy(n=4000, f=6, seed=0):
    """The pinned workload of tests/test_scan_trainer.py."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, f))
    w = jax.random.normal(jax.random.fold_in(key, 1), (f,))
    y = (x @ w > 0).astype(jnp.float32)
    return x, y


@pytest.fixture(scope="module")
def toy():
    x, y = _toy()
    x = np.array(x)
    x[::37, 2] = np.nan            # NaN rows on the served batch
    return x, np.array(y)


@pytest.fixture(scope="module", params=[True, False],
                ids=["repropose", "fixed_grid"])
def trained(request, toy):
    """A JAX-trained random-proposal model; ``fixed_grid`` can serve
    binned."""
    x, y = _toy()
    cfg = repro.GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                           strategy="random",
                           repropose_each_round=request.param)
    return repro.fit(x, y, cfg, jax.random.PRNGKey(3))


def _margins_equal(jm, tm, x, binned):
    want = np.asarray(jm.predict(jnp.asarray(x), output="margin",
                                 binned=binned))
    got = tm.predict(x, output="margin", binned=binned).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    assert np.array_equal(got, want), np.abs(got - want).max()


# -- the pinned fixture ------------------------------------------------------

@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, N_TREES])
def test_forest_predict_bit_identical(jmodel, tmodel, x_nan, binned, chunk):
    values = jmodel.bin_features(jnp.asarray(x_nan)) if binned else x_nan
    want = jpredict.forest_predict(jmodel.forest, jnp.asarray(values),
                                   max_depth=DEPTH, binned=binned,
                                   tree_chunk=chunk, backend="ref")
    got = predict.forest_predict(tmodel.forest, np.array(values),
                                 max_depth=DEPTH, binned=binned,
                                 tree_chunk=chunk)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_per_tree_oracles_match(jmodel, tmodel, x_nan):
    bins = np.asarray(jmodel.bin_features(jnp.asarray(x_nan)), np.int32)
    for jt, tt in zip(jtree.forest_trees(jmodel.forest),
                      tree.forest_trees(tmodel.forest)):
        assert np.array_equal(
            tree.predict_raw(tt, torch.from_numpy(x_nan),
                             max_depth=DEPTH).numpy(),
            np.asarray(jtree.predict_raw(jt, jnp.asarray(x_nan),
                                         max_depth=DEPTH)))
        assert np.array_equal(
            tree.predict_binned(tt, torch.from_numpy(bins),
                                max_depth=DEPTH).numpy(),
            np.asarray(jtree.predict_binned(jt, jnp.asarray(bins),
                                            max_depth=DEPTH)))
    scan = tree._forest_predict_scan(tmodel.forest, torch.from_numpy(x_nan),
                                     max_depth=DEPTH)
    assert np.array_equal(scan.numpy(), np.asarray(jtree._forest_predict_scan(
        jmodel.forest, jnp.asarray(x_nan), max_depth=DEPTH)))
    # the batched engine equals its own per-tree oracle
    assert np.array_equal(scan.numpy(), predict.forest_predict(
        tmodel.forest, x_nan, max_depth=DEPTH, tree_chunk=7).numpy())
    restacked = tree.forest_from_trees(tree.forest_trees(tmodel.forest))
    assert all(torch.equal(a, b) for a, b in zip(restacked, tmodel.forest))


@pytest.mark.parametrize("binned", [False, True])
def test_margin_bit_identical(jmodel, tmodel, x_nan, binned):
    """``base + lr * sum`` as two rounded operations on both sides."""
    values = jmodel.bin_features(jnp.asarray(x_nan)) if binned else x_nan
    want = jpredict.margin(jmodel.forest, jnp.asarray(values), 0.25, 0.3,
                           max_depth=DEPTH,
                           spec=JTraverseSpec(tree_chunk=5, binned=binned,
                                              backend="ref"))
    got = predict.margin(tmodel.forest, np.array(values), 0.25, 0.3,
                         max_depth=DEPTH,
                         spec=repro_torch.TraverseSpec(tree_chunk=5,
                                                       binned=binned))
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("output", ["margin", "proba", "label"])
@pytest.mark.parametrize("binned", [False, True])
def test_model_predict_every_output(jmodel, tmodel, x_nan, output, binned):
    jx = jnp.asarray(x_nan)
    want = np.asarray(jmodel.predict(jx, output=output, binned=binned))
    got = tmodel.predict(x_nan, output=output, binned=binned).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    if output == "margin":
        assert np.array_equal(got, want)
    elif output == "proba":
        np.testing.assert_allclose(got, want, atol=1e-7, rtol=1e-6)
    else:
        m = np.asarray(jmodel.predict(jx, output="margin", binned=binned))
        sure = np.abs(m) > 1e-6
        assert np.array_equal(got[sure], want[sure])


def test_prebinned_and_empty_batches(jmodel, tmodel, x_nan):
    bins = tmodel.bin_features(x_nan)
    assert bins.dtype == torch.uint8
    assert np.array_equal(
        tmodel.predict(bins, output="margin", binned=True).numpy(),
        np.asarray(jmodel.predict(jnp.asarray(x_nan), output="margin",
                                  binned=True)))
    x0 = np.zeros((0, F), np.float32)
    assert tmodel.predict(x0, output="margin").shape == (0,)
    assert predict.forest_predict(tmodel.forest, x0,
                                  max_depth=DEPTH).shape == (0,)


@pytest.mark.parametrize("k", [8, 32, 100])
def test_bin_ids_integer_exact(k):
    """k <= 64 takes the dense count, k = 100 searchsorted; the grid has
    ties, and NaN cells and a NaN row go to bin k."""
    rng = np.random.default_rng(k)
    cands = np.sort(rng.normal(size=(F, k)).astype(np.float32), axis=1)
    cands[:, 1] = cands[:, 2]                         # a tie in the grid
    x = rng.normal(size=(200, F)).astype(np.float32)
    x[::9, 3] = np.nan
    x[4, :] = np.nan
    x[7, :] = cands[:, 2]                             # values on an edge
    want = np.asarray(jbinning.bin_features(jnp.asarray(x),
                                            jnp.asarray(cands)))
    got = binning.bin_features(torch.from_numpy(x), torch.from_numpy(cands))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert (got.numpy()[4] == k).all()


# -- a model trained by the JAX package --------------------------------------

def test_trained_model_carried_across(trained, toy):
    x, y = toy
    tm = _carry(trained)
    assert tm.config == repro_torch.GBDTConfig(
        **dataclasses.asdict(trained.config))
    _margins_equal(trained, tm, x, binned=False)
    if trained.bin_edges is not None:
        _margins_equal(trained, tm, x, binned=True)
        assert np.array_equal(
            tm.bin_features(x).numpy(),
            np.asarray(trained.bin_features(jnp.asarray(x))))
    else:
        with pytest.raises(ValueError, match="fixed candidate grid"):
            tm.predict(x, binned=True)
    # the labels agree exactly; the float32 mean over them is rounded
    # differently by the two frameworks (within one ulp)
    assert repro_torch.accuracy(tm, x, y) == pytest.approx(
        repro.accuracy(trained, x, y), abs=1e-6)


def test_checkpoint_jax_to_torch(trained, toy, tmp_path):
    x, _ = toy
    path = str(tmp_path / "jax.npz")
    repro.save_gbdt(path, trained)
    tm = repro_torch.load_gbdt(path, device="cpu")
    assert dataclasses.asdict(tm.config) == dataclasses.asdict(trained.config)
    assert tm.base_score == trained.base_score
    _margins_equal(trained, tm, x, binned=False)
    if trained.bin_edges is not None:
        _margins_equal(trained, tm, x, binned=True)


def test_checkpoint_torch_to_jax(trained, toy, tmp_path):
    x, _ = toy
    tm = _carry(trained)
    path = str(tmp_path / "torch.npz")
    repro_torch.save_gbdt(path, tm)
    jm = repro.load_gbdt(path)
    assert jm.config == trained.config
    assert jm.base_score == tm.base_score
    _margins_equal(jm, tm, x, binned=False)
    if jm.bin_edges is not None:
        _margins_equal(jm, tm, x, binned=True)
    # and the port reloads its own file bit for bit
    _margins_equal(jm, repro_torch.load_gbdt(path, device="cpu"), x,
                   binned=False)


def test_regression_model_and_mape():
    """An mse model: 'label' is the margin, 'proba' raises, and mape
    agrees up to the float32 mean's rounding."""
    kw = dict(n_trees=9, max_depth=3, n_features=F, n_candidates=K, seed=2,
              objective="mse", learning_rate=0.5)
    jm = synthetic_gbdt(**kw)
    tm = _carry(jm)
    x = np.random.default_rng(4).normal(size=(64, F)).astype(np.float32)
    y = np.random.default_rng(5).normal(size=(64,)).astype(np.float32)
    y[3] = 0.0                                  # mape's zero-target guard
    assert np.array_equal(tm.predict(x).numpy(),
                          np.asarray(jm.predict(jnp.asarray(x))))
    with pytest.raises(ValueError, match="logistic"):
        tm.predict(x, output="proba")
    with pytest.raises(ValueError, match="classification"):
        repro_torch.accuracy(tm, x, y)
    assert repro_torch.core.boosting.mape(tm, x, y) == pytest.approx(
        repro.mape(jm, x, y), rel=1e-6)


def test_config_fields_match_reference():
    ours = [(f.name, f.default) for f in
            dataclasses.fields(repro_torch.GBDTConfig)]
    theirs = [(f.name, f.default) for f in
              dataclasses.fields(repro.GBDTConfig)]
    assert ours == theirs
    assert repro_torch.GBDTConfig().nbins == repro.GBDTConfig().nbins


def test_model_from_numpy_rejects_bad_input(jmodel, tmp_path):
    arrays = _arrays(jmodel)
    cfg = dataclasses.asdict(jmodel.config)
    bad = dict(arrays, **{"forest/feature": arrays["forest/feature"] + F})
    with pytest.raises(ValueError, match="feature ids"):
        repro_torch.model_from_numpy(bad, cfg, 0.0, device="cpu")
    bad = dict(arrays, **{"forest/threshold":
                          arrays["forest/threshold"].astype(np.float64)})
    with pytest.raises(TypeError):
        repro_torch.model_from_numpy(bad, cfg, 0.0, device="cpu")
    path = str(tmp_path / "bad.npz")
    np.savez(path, schema=np.array("something/else"))
    with pytest.raises(ValueError, match="schema"):
        repro_torch.load_gbdt(path, device="cpu")
