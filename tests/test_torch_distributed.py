"""Parity of the port's distributed trainer with the JAX package's (CPU).

``repro_torch.fit_distributed`` runs on gloo ranks that
``repro_torch.launch.distributed.run`` starts, one start a world size.
The JAX side runs once a module in a subprocess with 8 forced host
devices, as tests/test_distributed.py runs it: one distributed tree under
``shard_map`` and the fits of :data:`FITS` on that file's pinned
workloads (8192 x 6; 1003 x 4, padded to 1008 rows at 8 workers and to
1005 at 3), saved to an npz.  Contracts:

  * one direct tree on 8 ranks is bit-equal to JAX's ``build_tree(axis_
    name=...)``: tree, leaf ids, leaf values.  On the CPU every float sum
    crosses as an all-gather added in rank order, which is XLA:CPU's
    ``psum``; subtraction growth keeps the port's single-host departure
    (empty buckets zeroed), and its structure is exact here;
  * whole fits: structure exact, thresholds within 1e-6, leaves within
    1e-5, base score within 1e-6 (``fit``'s contracts).  uniform_range and
    gk_quantile propose their own grids, bit-equal to JAX's; random and
    weighted_quantile are fed the JAX model's (the RNG streams differ,
    and sigmoid rounds 1 ulp apart);
  * the TrainReport: integer fields exact, float fields within rtol 1e-5,
    the collective bytes exact;
  * the port's own random draws meet tests/test_distributed.py's bounds at
    8 ranks, and repeat from one seed;
  * ``merge_quantile_gathered`` is the jitted JAX function index for index;
  * the card's fixed-point reduction, driven here through its plain
    versions: the panels, row counts and leaf sums of W ranks on one
    shared grid are single-process ``ref.hist_levels_fixed`` /
    ``ref.fixed_point_sums`` bit for bit, pad rows and a NaN on one rank
    included;
  * serving with ``data_shards=2`` gives the unsharded margins bit for bit.
"""

import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch
from repro_torch import GBDTConfig
from repro_torch.core import distributed as distributed_lib, tree as tree_lib
from repro_torch.kernels import ref
from repro_torch.kernels.ops import HistSpec
from repro_torch.launch import distributed as dist_lib, distributed_gbdt, \
    serve_gbdt

ROOT = Path(__file__).resolve().parents[1]

# name -> (workload, world size, GBDTConfig fields, reference)
FITS = {
    "a/random": ("a", 8, dict(strategy="random", telemetry=True), False),
    "a/weighted_quantile": ("a", 8, dict(strategy="weighted_quantile",
                                         telemetry=True), False),
    "a/uniform_range": ("a", 8, dict(strategy="uniform_range",
                                     telemetry=True), False),
    "a/gk_quantile": ("a", 8, dict(strategy="gk_quantile", telemetry=True),
                      False),
    "a/uniform_range/subtract": ("a", 8, dict(
        strategy="uniform_range", subtract=True, telemetry=True), False),
    "a/weighted_quantile/fixed_grid": ("a", 8, dict(
        strategy="weighted_quantile", repropose_each_round=False), False),
    "b/uniform_range/8": ("b", 8, dict(strategy="uniform_range"), False),
    "b/uniform_range/8/reference": ("b", 8, dict(strategy="uniform_range"),
                                    True),
    "b/weighted_quantile/8": ("b", 8, dict(strategy="weighted_quantile"),
                              False),
    "b/uniform_range/3": ("b", 3, dict(strategy="uniform_range"), False),
    "b/weighted_quantile/3": ("b", 3, dict(strategy="weighted_quantile",
                                           telemetry=True), False),
    "b/gk_quantile/3/subtract": ("b", 3, dict(
        strategy="gk_quantile", subtract=True), False),
}
WORKLOADS = {"a": (8192, 6, 16), "b": (1003, 4, 8)}   # rows, features, k
TREE = dict(n=4096, f=5, nbins=17, depth=4)

_JAX_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import boosting, distributed, tree as jtree
from repro.kernels.ops import HistSpec

out_path, fits, workloads, tree = sys.argv[1], *map(json.loads, sys.argv[2:])
out = {}


def mesh_of(w):
    return Mesh(np.array(jax.devices()[:w]).reshape(w), ("data",))


for name, (n, f, _) in workloads.items():
    # tests/test_distributed.py's workloads
    key = jax.random.PRNGKey(7)
    x = jax.random.normal(key, (n, f))
    w = jax.random.normal(jax.random.fold_in(key, 1), (f,))
    out[f"data/{name}/x"] = np.asarray(x)
    out[f"data/{name}/y"] = np.asarray((x @ w > 0).astype(jnp.float32))

rng = np.random.default_rng(11)
n, f, nb, depth = tree["n"], tree["f"], tree["nbins"], tree["depth"]
bins = rng.integers(0, nb, (n, f)).astype(np.int32)
gh = np.stack([rng.normal(size=n), rng.uniform(0.05, 0.25, size=n)],
              1).astype(np.float32)
cands = np.sort(rng.normal(size=(f, nb - 1)).astype(np.float32), 1)
out["tree/bins"], out["tree/gh"], out["tree/cands"] = bins, gh, cands
for subtract in (False, True):
    spec = HistSpec(n_nodes=2 ** (depth - 1), nbins=nb, n_levels=depth,
                    backend="ref", subtract=subtract)

    def one(b, q, c):
        return jtree.build_tree(b, q, c, max_depth=depth, spec=spec,
                                axis_name="data", return_leaf_nodes=True)

    fn = jax.jit(compat.shard_map(
        one, mesh=mesh_of(8), in_specs=(P("data"), P("data"), P()),
        out_specs=(P(), P("data")), check_vma=False))
    t, node = fn(jnp.asarray(bins), jnp.asarray(gh), jnp.asarray(cands))
    for field, a in zip(t._fields, t):
        out[f"tree/{subtract}/{field}"] = np.asarray(a)
    out[f"tree/{subtract}/node"] = np.asarray(node)

# the base score of 903 rows with 309 positives, where float32 division
# and a product with float32(1/903) round apart
x = jax.random.normal(jax.random.PRNGKey(3), (903, 3))
y = jnp.zeros(903, jnp.float32).at[:309].set(1.0)
m = distributed.fit_distributed(
    x, y, boosting.GBDTConfig(n_trees=1, max_depth=1, n_candidates=4,
                              strategy="uniform_range", objective="mse"),
    mesh_of(8), jax.random.PRNGKey(7))
out["base/x"], out["base/y"] = np.asarray(x), np.asarray(y)
out["base/jax"] = np.float32(m.base_score)

for name, (data, workers, kw, reference) in fits.items():
    n, f, k = workloads[data]
    cfg = boosting.GBDTConfig(n_trees=4, max_depth=4, n_candidates=k, **kw)
    m = distributed.fit_distributed(
        jnp.asarray(out[f"data/{data}/x"]), jnp.asarray(out[f"data/{data}/y"]),
        cfg, mesh_of(workers), jax.random.PRNGKey(7), reference=reference)
    for field, a in zip(m.forest._fields, m.forest):
        out[f"fit/{name}/{field}"] = np.asarray(a)
    out[f"fit/{name}/candidates"] = np.asarray(m.candidates)
    out[f"fit/{name}/base"] = np.float64(m.base_score)
    if m.report is not None:
        for field, a in zip(m.report._fields, m.report):
            out[f"fit/{name}/report/{field}"] = np.asarray(a)
np.savez(out_path, **out)
"""


def _config(name: str) -> GBDTConfig:
    data, _, kw, _ = FITS[name]
    return GBDTConfig(n_trees=4, max_depth=4,
                      n_candidates=WORKLOADS[data][2], **kw)


def _numpy(t):
    return t.detach().cpu().numpy()


# ---------------------------------------------------------------------------
# What each rank runs (top-level functions: ``run`` pickles them).
# ---------------------------------------------------------------------------

def _same_on_every_rank(t: torch.Tensor) -> bool:
    return all(torch.equal(p, t) for p in dist_lib.all_gather(t))


def _fits_on_ranks(arrays: dict, names: list[str]) -> dict:
    """The fits of ``names`` (fed the JAX grids of the strategies that
    draw), and for each whether every rank returned the same forest."""
    out = {}
    for name in names:
        data, _, kw, reference = FITS[name]
        cfg = _config(name)
        cands = (arrays[f"fit/{name}/candidates"]
                 if cfg.strategy in ("random", "weighted_quantile") else None)
        m = repro_torch.fit_distributed(
            arrays[f"data/{data}/x"], arrays[f"data/{data}/y"], cfg,
            candidates=cands, reference=reference, device="cpu")
        out[name] = dict(
            forest={f: _numpy(a) for f, a in zip(m.forest._fields, m.forest)},
            candidates=_numpy(m.candidates), base=m.base_score,
            report=None if m.report is None else {
                f: _numpy(a) for f, a in zip(m.report._fields, m.report)},
            same_on_every_rank=all(_same_on_every_rank(a) for a in m.forest))
    return out


def _tree_on_ranks(arrays: dict, subtract: bool) -> dict:
    """One distributed tree on the JAX test's bins and g/h; the leaf ids
    of every rank's rows, gathered in rank order."""
    world, rank = dist.get_world_size(), dist.get_rank()
    per = TREE["n"] // world
    rows = slice(rank * per, (rank + 1) * per)
    bins = torch.from_numpy(arrays["tree/bins"][rows])
    gh = torch.from_numpy(arrays["tree/gh"][rows])
    depth = TREE["depth"]
    spec = HistSpec(n_nodes=2 ** (depth - 1), nbins=TREE["nbins"],
                    n_levels=depth, subtract=subtract)
    t, node = tree_lib.build_tree(
        bins, gh, torch.from_numpy(arrays["tree/cands"]), max_depth=depth,
        spec=spec, return_leaf_nodes=True,
        reduce=distributed_lib.TreeReduce(gh, n_global=TREE["n"]))
    return dict(tree={f: _numpy(a) for f, a in zip(t._fields, t)},
                node=_numpy(torch.cat(dist_lib.all_gather(node))))


def _own_draws(arrays: dict) -> dict:
    """tests/test_distributed.py's accuracy runs with the port's own draws
    (random twice from one seed), at 8 ranks."""
    x, y = arrays["data/a/x"], arrays["data/a/y"]
    out = {}
    for strategy in ("random", "weighted_quantile"):
        cfg = GBDTConfig(n_trees=4, max_depth=4, n_candidates=16,
                         strategy=strategy)
        m = repro_torch.fit_distributed(x, y, cfg, seed=7, device="cpu")
        out[strategy] = repro_torch.accuracy(m, x, y)
        if strategy == "random":
            again = repro_torch.fit_distributed(x, y, cfg, seed=7,
                                                device="cpu")
            out["random_repeats"] = all(
                torch.equal(a, b) for a, b in zip(m.forest, again.forest))
    return out


def _fixed_point_case():
    """Bins, node ids (direct and child), g/h with a NaN g in one row of
    rank 1's slice (when there is one), and leaf ids: 1003 rows, as the
    padded fits have them."""
    rng = np.random.default_rng(5)
    n, f, nbins, n_nodes = 1003, 4, 9, 4
    bins = rng.integers(0, nbins, (n, f)).astype(np.int32)
    node = rng.integers(-1, n_nodes, (2, n)).astype(np.int32)
    child = rng.integers(-1, 2 * n_nodes, (2, n)).astype(np.int32)
    gh = np.stack([rng.normal(size=n) * 3, rng.uniform(0, 2, size=n)],
                  1).astype(np.float32)
    leaf = rng.integers(0, 16, n).astype(np.int64)
    return bins, node, child, gh, leaf, dict(n_nodes=n_nodes, nbins=nbins)


def _fixed_point_on_ranks(nan_row: int | None) -> dict:
    """The card's reduction through its plain versions: each rank holds a
    slice of the rows, padded as ``fit_distributed`` pads (repeats of the
    leading rows, g = h = 0), on the grid shared by every rank."""
    world, rank = dist.get_world_size(), dist.get_rank()
    bins, node, child, gh, leaf, kw = _fixed_point_case()
    if nan_row is not None:
        gh[nan_row, 0] = np.nan
    n = gh.shape[0]
    pad = -n % world
    gh_pad = np.concatenate([gh, np.zeros((pad, 2), np.float32)])
    per = (n + pad) // world
    rows = slice(rank * per, (rank + 1) * per)

    def mine(a, axis=0):
        full = np.concatenate([a, a.take(np.arange(pad), axis)], axis)
        return torch.from_numpy(np.ascontiguousarray(
            full[rows] if axis == 0 else full[:, rows]))

    g_local = torch.from_numpy(gh_pad[rows])
    bits = distributed_lib.shared_max_bits(g_local)
    log2n = ref.log2_ceil(n)
    out = {"bits": _numpy(bits), "log2n": log2n}
    for subtract, ids in ((False, node), (True, child)):
        spec = HistSpec(n_levels=2, subtract=subtract, **kw)
        got = distributed_lib.fixed_point_hist(
            mine(bins), mine(ids, axis=1), g_local, spec, bits=bits,
            log2n=log2n)
        out[f"hist/{subtract}"] = ([_numpy(a) for a in got] if subtract
                                   else _numpy(got))
    out["leaf"] = _numpy(distributed_lib.fixed_point_leaf_sums(
        mine(leaf), g_local, 16, bits=bits, log2n=log2n))
    return out


def _suite(arrays: dict | None, names: list[str]) -> dict:
    """Everything a world size checks, in one start of its ranks."""
    world = dist.get_world_size()
    out = {"fits": _fits_on_ranks(arrays, names) if names else {},
           "fixed_point": {nan: _fixed_point_on_ranks(nan)
                           for nan in (None, 600)}}
    if world == 8:
        out["tree"] = {s: _tree_on_ranks(arrays, s) for s in (False, True)}
        out["own_draws"] = _own_draws(arrays)
        out["base"] = repro_torch.fit_distributed(
            arrays["base/x"], arrays["base/y"],
            GBDTConfig(n_trees=1, max_depth=1, n_candidates=4,
                       strategy="uniform_range", objective="mse"),
            device="cpu").base_score
    return out


def _serve_on_ranks() -> dict:
    """Two ranks serving the 60 x 4 x 8 synthetic forest: the margins of
    every request sharded and unsharded, and ``serve``'s report."""
    model = serve_gbdt.synthetic_gbdt(n_trees=60, max_depth=4, n_features=8,
                                      n_candidates=16, seed=3, device="cpu")
    batches = serve_gbdt.request_batches(model, microbatch=1001,
                                         n_requests=3, seed=0)
    equal = []
    for xb in batches:
        for binned in (False, True):
            kw = dict(output="margin", binned=binned)
            got = serve_gbdt.shard_predict(model, xb, **kw)
            equal.append(torch.equal(got, model.predict(xb, **kw)))
    report = serve_gbdt.serve(model, microbatch=1001, n_requests=3,
                              data_shards=2)
    return {"equal": equal, "engine": report.engine}


# ---------------------------------------------------------------------------
# Fixtures: the JAX reference once, then one start of ranks a world size.
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("jax_dist") / "ref.npz"
    env = dict(os.environ,
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join(
                   [str(ROOT / "src")]
                   + os.environ.get("PYTHONPATH", "").split(os.pathsep)))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_SCRIPT, str(path),
         json.dumps({k: [d, w, kw, r] for k, (d, w, kw, r) in FITS.items()}),
         json.dumps(WORKLOADS), json.dumps(TREE)],
        env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    with np.load(path) as z:
        return dict(z)


def _names(world: int) -> list[str]:
    return [k for k, v in FITS.items() if v[1] == world]


@pytest.fixture(scope="module")
def ranks8(jax_ref):
    return dist_lib.run(_suite, 8, jax_ref, _names(8), device="cpu")


@pytest.fixture(scope="module")
def ranks3(jax_ref):
    return dist_lib.run(_suite, 3, jax_ref, _names(3), device="cpu")


@pytest.fixture(scope="module")
def ranks1():
    return dist_lib.run(_suite, 1, None, [], device="cpu")


@pytest.fixture(scope="module")
def fits(ranks8, ranks3):
    return {**ranks8["fits"], **ranks3["fits"]}


# ---------------------------------------------------------------------------
# One tree.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("subtract", [False, True],
                         ids=["direct", "subtract"])
def test_one_tree_is_the_jax_tree(ranks8, jax_ref, subtract):
    got = ranks8["tree"][subtract]
    for field, a in got["tree"].items():
        np.testing.assert_array_equal(a, jax_ref[f"tree/{subtract}/{field}"],
                                      err_msg=field)
    np.testing.assert_array_equal(got["node"],
                                  jax_ref[f"tree/{subtract}/node"])


# ---------------------------------------------------------------------------
# Whole fits.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(FITS))
def test_fit_matches_jax(fits, jax_ref, name):
    got = fits[name]
    want = {f: jax_ref[f"fit/{name}/{f}"]
            for f in ("feature", "split_bin", "threshold", "leaf_value")}
    assert got["same_on_every_rank"]
    np.testing.assert_array_equal(got["forest"]["feature"], want["feature"])
    np.testing.assert_array_equal(got["forest"]["split_bin"],
                                  want["split_bin"])
    np.testing.assert_allclose(got["forest"]["threshold"], want["threshold"],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(got["forest"]["leaf_value"],
                               want["leaf_value"], atol=1e-5, rtol=0)
    assert abs(got["base"] - float(jax_ref[f"fit/{name}/base"])) <= 1e-6
    # the grids: proposed bit for bit, or fed
    np.testing.assert_array_equal(got["candidates"],
                                  jax_ref[f"fit/{name}/candidates"])


@pytest.mark.parametrize("name", sorted(
    k for k, v in FITS.items() if v[2].get("telemetry")))
def test_report_matches_jax(fits, jax_ref, name):
    got = fits[name]["report"]
    for field, a in got.items():
        want = jax_ref[f"fit/{name}/report/{field}"]
        assert a.shape == want.shape, field
        if field.endswith("_bytes") or np.issubdtype(want.dtype, np.integer):
            np.testing.assert_array_equal(a, want, err_msg=field)
        else:
            np.testing.assert_allclose(a, want, rtol=1e-5, atol=0,
                                       err_msg=field)


def test_base_score_is_the_jax_product_with_the_reciprocal(ranks8,
                                                           jax_ref):
    """XLA:CPU compiles the JAX worker's ``ysum / n_global`` to
    ``ysum * float32(1/n_global)``; at 903 rows with 309 positives that
    rounds apart from the quotient, and the port gives the product."""
    want = jax_ref["base/jax"]
    assert np.float32(ranks8["base"]) == want
    assert want == np.float32(309) * np.float32(1 / 903)
    assert want != np.float32(309) / np.float32(903)


def test_reference_worker_gives_the_scanned_forest(fits):
    a = fits["b/uniform_range/8"]["forest"]
    b = fits["b/uniform_range/8/reference"]["forest"]
    for field in a:
        np.testing.assert_array_equal(a[field], b[field], err_msg=field)


def test_padded_fit_is_the_single_host_fit(fits, jax_ref):
    """tests/test_distributed.py's padding check on the port, with its
    bounds: with the uniform_range grid the padded fit at 8 and at 3
    ranks has the port's single-host trees, leaves within 1e-4 (the
    ranks' sums associate otherwise than one row-order sum) and the base
    score within 1e-5 (float32 here, float64 on one host)."""
    cfg = _config("b/uniform_range/8")
    single = repro_torch.fit(jax_ref["data/b/x"], jax_ref["data/b/y"], cfg,
                             device="cpu")
    for name in ("b/uniform_range/8", "b/uniform_range/3"):
        got = fits[name]
        np.testing.assert_array_equal(got["forest"]["feature"],
                                      _numpy(single.forest.feature))
        np.testing.assert_array_equal(got["forest"]["split_bin"],
                                      _numpy(single.forest.split_bin))
        np.testing.assert_allclose(got["forest"]["leaf_value"],
                                   _numpy(single.forest.leaf_value),
                                   atol=1e-4, rtol=0)
        assert abs(got["base"] - single.base_score) < 1e-5


def test_own_random_learns_at_8_ranks(ranks8):
    assert ranks8["own_draws"]["random"] > 0.85, ranks8["own_draws"]


def test_own_random_matches_quantile(ranks8):
    """Paper claim, distributed: S ~= Q accuracy."""
    acc = ranks8["own_draws"]
    assert abs(acc["random"] - acc["weighted_quantile"]) < 0.03, acc


def test_own_random_matches_single_host(ranks8, jax_ref):
    x, y = jax_ref["data/a/x"], jax_ref["data/a/y"]
    cfg = GBDTConfig(n_trees=4, max_depth=4, n_candidates=16)
    single = repro_torch.fit(x, y, cfg, torch.Generator().manual_seed(7),
                             device="cpu")
    acc = ranks8["own_draws"]["random"]
    assert abs(acc - repro_torch.accuracy(single, x, y)) < 0.03


def test_own_random_repeats_from_one_seed(ranks8):
    assert ranks8["own_draws"]["random_repeats"]


def test_exact_has_no_distributed_form():
    with pytest.raises(ValueError, match="no distributed form"):
        repro_torch.fit_distributed(np.zeros((8, 2), np.float32),
                                    np.zeros(8, np.float32),
                                    GBDTConfig(strategy="exact"),
                                    device="cpu")


def test_injected_grid_shape_is_checked():
    with pytest.raises(ValueError, match="candidates must have shape"):
        repro_torch.fit_distributed(
            np.zeros((8, 2), np.float32), np.zeros(8, np.float32),
            GBDTConfig(n_trees=3, n_candidates=4),
            candidates=np.zeros((1, 2, 4), np.float32), device="cpu")


# ---------------------------------------------------------------------------
# The merge, and the report's distributed arguments.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("workers", [1, 3, 8])
@pytest.mark.parametrize("k", [8, 16, 32, 255])
def test_merge_quantile_gathered_matches_jitted_jax(workers, k):
    import jax
    from repro.core.distributed import merge_quantile_gathered as jax_merge
    rng = np.random.default_rng(workers * 1000 + k)
    gathered = rng.normal(size=(workers, 3, k)).astype(np.float32)
    gathered[0, 1, :2] = np.nan        # NaN sorts last on both
    gathered[-1, 2] = gathered[0, 2]   # ties
    want = np.asarray(jax.jit(jax_merge, static_argnums=1)(gathered, k))
    got = distributed_lib.merge_quantile_gathered(
        torch.from_numpy(gathered), k)
    np.testing.assert_array_equal(_numpy(got), want)


@pytest.mark.parametrize("objective", ["logistic", "mse"])
def test_report_with_group_arguments_matches_jax(objective):
    """``mean_train_loss`` and ``round_report`` with ``weight``,
    ``n_global`` and ``psum``: ``psum`` doubles (two ranks holding the
    same rows), on both sides."""
    import jax.numpy as jnp
    from repro.core.tree import TreeStats as JStats
    from repro.obs import report as jreport
    from repro_torch.obs import report
    rng = np.random.default_rng(2)
    n = 500
    margin = rng.normal(size=n).astype(np.float32) * 3
    y = (rng.random(n) > 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    w[-7:] = 0.0
    g, h = rng.normal(size=(2, n)).astype(np.float32) * w
    stats = (np.int32(5), np.float32(3.25), np.float32(1.5),
             np.float32(n * 3))
    kw = dict(objective=objective, n_global=2 * (n - 7))
    want = jreport.round_report(
        margin=jnp.asarray(margin), y=jnp.asarray(y), g=jnp.asarray(g),
        h=jnp.asarray(h), stats=JStats(*map(jnp.asarray, stats)),
        weight=jnp.asarray(w), psum=lambda a: a + a, **kw)
    got = report.round_report(
        margin=torch.from_numpy(margin), y=torch.from_numpy(y),
        g=torch.from_numpy(g), h=torch.from_numpy(h),
        stats=tree_lib.TreeStats(*map(torch.as_tensor, stats)),
        weight=torch.from_numpy(w), psum=lambda a: a + a, **kw)
    for field, a, b in zip(got._fields, got, want):
        np.testing.assert_allclose(_numpy(a), np.asarray(b), rtol=1e-5,
                                   err_msg=field)
    loss = report.mean_train_loss(
        torch.from_numpy(margin), torch.from_numpy(y), objective,
        weight=torch.from_numpy(w), psum=lambda a: a + a, n_global=kw[
            "n_global"])
    np.testing.assert_allclose(_numpy(loss), _numpy(got.train_loss),
                               rtol=0)


# ---------------------------------------------------------------------------
# The card's fixed-point reduction, through its plain versions.
# ---------------------------------------------------------------------------

def _bits_equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        a.view(np.int32) if a.dtype == np.float32 else a,
        b.view(np.int32) if b.dtype == np.float32 else b)


@pytest.mark.parametrize("world", [1, 3, 8])
@pytest.mark.parametrize("nan", [None, 600], ids=["finite", "nan_g"])
def test_fixed_point_reduction_is_one_process_sum(ranks1, ranks3, ranks8,
                                                  world, nan):
    got = {1: ranks1, 3: ranks3, 8: ranks8}[world]["fixed_point"][nan]
    bins, node, child, gh, leaf, kw = _fixed_point_case()
    if nan is not None:
        gh[nan, 0] = np.nan
    t = torch.from_numpy
    np.testing.assert_array_equal(got["bits"], _numpy(ref.max_bits(t(gh))))
    want = ref.hist_levels_fixed(t(bins), t(node), t(gh), **kw)
    assert _bits_equal(got["hist/False"], _numpy(want))
    want, _ = ref.hist_levels_fixed(t(bins), t(child), t(gh), child=True,
                                    **kw)
    assert _bits_equal(got["hist/True"][0], _numpy(want))
    # the counts include the pad rows (repeats of the leading rows)
    pad = -len(gh) % world
    padded = [np.concatenate([a, a.take(np.arange(pad), -1)], -1)
              for a in (bins.T, child)]
    _, cnt = ref.hist_levels_left_ref(t(np.ascontiguousarray(padded[0].T)),
                                      t(padded[1]), t(np.zeros(
                                          (len(gh) + pad, 2), np.float32)),
                                      **kw)
    np.testing.assert_array_equal(got["hist/True"][1], _numpy(cnt))
    assert _bits_equal(got["leaf"], _numpy(ref.fixed_point_sums(
        t(leaf), t(gh), 16)))
    if nan is not None:
        assert np.isnan(got["leaf"][:, 0]).all()
        assert np.isfinite(got["leaf"][:, 1]).all()


# ---------------------------------------------------------------------------
# Serving from two ranks, the example, the public surface.
# ---------------------------------------------------------------------------

def test_sharded_serving_is_bit_identical():
    out = dist_lib.run(_serve_on_ranks, 2, device="cpu")
    assert out["equal"] and all(out["equal"])
    assert out["engine"]["data_shards"] == 2


def test_serve_refuses_shards_without_a_group():
    model = serve_gbdt.synthetic_gbdt(n_trees=2, max_depth=2, n_features=3,
                                      device="cpu")
    with pytest.raises(ValueError, match="data_shards=2"):
        serve_gbdt.serve(model, microbatch=8, n_requests=1, data_shards=2)


def test_distributed_gbdt_example_runs(capsys):
    out = distributed_gbdt.main(["--workers", "3", "--device", "cpu",
                                 "--n-train", "3000", "--n-test", "1000",
                                 "--trees", "3", "--depth", "3"])
    text = capsys.readouterr().out
    assert "ranks: 3 on cpu" in text and "single-host" in text
    for strategy in distributed_gbdt.STRATEGIES:
        r = out["results"][strategy]
        assert r["acc"] > 0.7 and r["loss_final"] < r["loss_first"]
        assert r["collective_bytes_per_round_measured"] > 0
    assert out["results"]["single"]["acc"] > 0.7


def test_port_exports_the_jax_api():
    import repro
    assert set(repro.__all__) - {"traverse_trace_count"} <= set(
        repro_torch.__all__)
    assert repro_torch.fit_distributed is distributed_lib.fit_distributed


def test_world_size_one_uses_gloo_on_the_cpu_and_nccl_on_the_card():
    assert dist_lib.backend_for("cpu", 1) == "gloo"
    assert dist_lib.backend_for("cpu", 8) == "gloo"
    assert dist_lib.backend_for("cuda", 1) == "nccl"
    assert dist_lib.backend_for("cuda", 3) == "gloo"


def test_collectives_count_their_bytes():
    out = dist_lib.run(_count_bytes, 3, device="cpu")
    # all_gather: 3 ranks x 40 bytes; all_reduce: 8 bytes; the rank-order
    # sum is an all_gather of 4 floats
    assert out == {"after_gather": 120, "after_reduce": 128,
                   "after_sum": 128 + 48, "sum": [3.0, 6.0]}


def _count_bytes() -> dict:
    start = dist_lib.collective_bytes
    dist_lib.all_gather(torch.zeros(10))
    after_gather = dist_lib.collective_bytes - start
    dist_lib.all_reduce(torch.ones(2, dtype=torch.int32),
                        dist.ReduceOp.MAX)
    after_reduce = dist_lib.collective_bytes - start
    total = dist_lib.sum_in_rank_order(torch.tensor(
        [1.0, 2.0, 0.0, 0.0]))
    return {"after_gather": after_gather, "after_reduce": after_reduce,
            "after_sum": dist_lib.collective_bytes - start,
            "sum": total[:2].tolist()}


def test_a_failing_rank_fails_the_run():
    with pytest.raises(Exception, match="rank 1 fails"):
        dist_lib.run(_fail_on_rank_1, 2, device="cpu")


def _fail_on_rank_1():
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 fails")
    return dataclasses.asdict(GBDTConfig())
