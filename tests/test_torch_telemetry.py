"""Parity of the port's training telemetry (``TrainReport``) with the JAX
package's, on the CPU.

The workloads are tests/test_telemetry.py's.  The port's fit is fed the
JAX model's candidate grids (the RNG streams differ), so both reports
describe forests that meet the forest contract.  Contracts, with their
reasons:

  * integer-valued fields exact: ``n_splits`` and ``hist_updates``
    (counts, exact below 2^24) and the collective-byte fields (zero on a
    single host);
  * float fields within rtol 1e-5: the train loss, the norms and the
    gains come from g/h that ``torch.sigmoid`` and ``jax.nn.sigmoid``
    round 1 ulp apart in places, from leaves within the contract's
    1e-5, and from sums that XLA:CPU and torch associate differently;
  * telemetry changes no bit of the forest;
  * the JSON record has the JAX package's schema string and keys.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro
from repro import obs as jobs
import repro_torch
from repro_torch import obs
from repro_torch.core import tree


def _toy(n=2000, f=5, seed=0):
    """The workload of tests/test_telemetry.py."""
    key = jax.random.PRNGKey(seed)
    x = jax.random.normal(key, (n, f))
    w = jax.random.normal(jax.random.fold_in(key, 1), (f,))
    y = (x @ w > 0).astype(jnp.float32)
    return np.array(x), np.array(y)


CASES = {  # name: (_toy seed, key, config) of tests/test_telemetry.py
    "direct": (1, 0, dict(n_trees=5, max_depth=4, n_candidates=16,
                          telemetry=True)),
    "subtract": (1, 0, dict(n_trees=5, max_depth=4, n_candidates=16,
                            telemetry=True, subtract=True)),
    "loss_curve": (2, 0, dict(n_trees=8, max_depth=4, n_candidates=16,
                              telemetry=True)),
}

INTEGER_FIELDS = ("n_splits", "hist_updates", "all_gather_bytes",
                  "psum_bytes")


@pytest.fixture(scope="module", params=sorted(CASES))
def both(request):
    seed, key, kw = CASES[request.param]
    x, y = _toy(seed=seed)
    jm = repro.fit(x, y, repro.GBDTConfig(**kw), jax.random.PRNGKey(key))
    tm = repro_torch.fit(x, y, repro_torch.GBDTConfig(**kw),
                         candidates=np.asarray(jm.candidates), device="cpu")
    return x, y, jm, tm


def test_report_matches_jax(both):
    _, _, jm, tm = both
    assert isinstance(tm.report, repro_torch.TrainReport)
    assert tm.report._fields == jm.report._fields
    assert tm.report.n_rounds == jm.report.n_rounds == tm.config.n_trees
    for name in tm.report._fields:
        want = np.asarray(getattr(jm.report, name))
        got = getattr(tm.report, name).numpy()
        assert got.shape == want.shape == (tm.config.n_trees,), name
        assert got.dtype == want.dtype, name
        if name in INTEGER_FIELDS:
            assert np.array_equal(got, want), (name, got, want)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, err_msg=name)


def test_report_describes_its_forest(both):
    """tests/test_telemetry.py's consistency checks, on the port."""
    x, _, _, tm = both
    rep, cfg = tm.report, tm.config
    realized = (tm.forest.feature >= 0).sum(dim=1)
    assert torch.equal(rep.n_splits, realized.to(torch.int32))
    assert bool((rep.best_gain_max >= rep.best_gain_mean).all())
    assert bool((rep.best_gain_mean >= 0).all())
    n, f = x.shape
    direct = torch.full((cfg.n_trees,), float(n * f * cfg.max_depth))
    if cfg.subtract:
        assert bool((rep.hist_updates < direct).all())
        assert bool((rep.hist_updates >= direct / cfg.max_depth).all())
    else:
        assert torch.equal(rep.hist_updates, direct)


def test_telemetry_does_not_change_the_forest(both):
    x, y, jm, tm = both
    off = repro_torch.fit(x, y, dataclasses.replace(tm.config,
                                                    telemetry=False),
                          candidates=np.asarray(jm.candidates), device="cpu")
    assert off.report is None
    for a, b in zip(tm.forest, off.forest):
        assert torch.equal(a, b)


def test_json_has_the_jax_schema(both, tmp_path):
    _, _, jm, tm = both
    got, want = json.loads(tm.report.to_json()), json.loads(
        jm.report.to_json())
    assert got["schema"] == want["schema"] == "repro.obs.TrainReport/v2"
    assert got.keys() == want.keys()
    assert got["rounds"].keys() == want["rounds"].keys()
    assert got["n_rounds"] == want["n_rounds"]
    for key, value in want["summary"].items():
        if isinstance(value, dict):
            assert got["summary"][key].keys() == value.keys(), key
    assert got["summary"]["splits"] == want["summary"]["splits"]
    path = tmp_path / "report.json"
    tm.report.to_json(str(path))
    assert json.loads(path.read_text()) == got


def test_model_to_moves_the_report(both):
    _, _, _, tm = both
    moved = tm.to("cpu")
    assert moved.report is not None
    for a, b in zip(moved.report, tm.report):
        assert torch.equal(a, b)


def test_loss_of_round_zero_is_an_independent_evaluation(both):
    x, y, _, tm = both
    first = tree.Tree(*(a[0] for a in tm.forest))
    margin = tm.base_score + tm.config.learning_rate * tree.predict_raw(
        first, torch.from_numpy(x), max_depth=tm.config.max_depth)
    loss = obs.mean_train_loss(margin.to(torch.float32),
                               torch.from_numpy(y), "logistic")
    assert float(tm.report.train_loss[0]) == pytest.approx(float(loss),
                                                           abs=1e-5)


@pytest.mark.parametrize("scale", [1.0, 25.0, 80.0])
def test_mean_train_loss_matches_jax(scale):
    """softplus as ``logaddexp(m, 0)``: equal to JAX's within float32
    rounding at every |margin|, beyond torch's softplus threshold (20)
    too."""
    rng = np.random.default_rng(0)
    margin = (rng.normal(size=256) * scale).astype(np.float32)
    if scale > 1:
        margin = np.sign(margin) * (np.abs(margin) + 20)
    y = (rng.random(256) > 0.5).astype(np.float32)
    for objective in ("logistic", "mse"):
        want = float(jobs.mean_train_loss(jnp.asarray(margin),
                                          jnp.asarray(y), objective))
        got = obs.mean_train_loss(torch.from_numpy(margin),
                                  torch.from_numpy(y), objective)
        assert got.dtype == torch.float32 and got.shape == ()
        assert float(got) == pytest.approx(want, rel=1e-6)
    with pytest.raises(ValueError, match="unknown objective"):
        obs.mean_train_loss(torch.zeros(3), torch.zeros(3), "huber")


def test_mean_train_loss_matches_numpy():
    """tests/test_telemetry.py's float64 reference."""
    rng = np.random.default_rng(0)
    margin = rng.normal(size=64).astype(np.float32)
    y = (rng.random(64) > 0.5).astype(np.float32)
    got = float(obs.mean_train_loss(torch.from_numpy(margin),
                                    torch.from_numpy(y), "logistic"))
    p = 1 / (1 + np.exp(-margin.astype(np.float64)))
    want = -(y * np.log(p) + (1 - y) * np.log(1 - p)).mean()
    assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("kw", [
    dict(), dict(subtract=True), dict(repropose_each_round=False),
    dict(strategy="uniform_range"), dict(strategy="exact"),
    dict(strategy="gk_quantile", telemetry=True),
    dict(max_depth=1, subtract=True, telemetry=True)])
def test_collective_bytes_match_jax(kw):
    kw = dict(dict(n_trees=4, max_depth=4, n_candidates=16), **kw)
    want = jobs.collective_bytes_per_round(repro.GBDTConfig(**kw),
                                           n_features=16, n_workers=8)
    got = obs.collective_bytes_per_round(repro_torch.GBDTConfig(**kw),
                                         n_features=16, n_workers=8)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_fit_without_telemetry_has_no_report():
    x, y = _toy(400, 3)
    m = repro_torch.fit(x, y, repro_torch.GBDTConfig(n_trees=2, max_depth=2),
                        device="cpu")
    assert m.config.telemetry is False and m.report is None
