"""Parity of the port's traversal kernel front end with the JAX package's.

The same numpy chunks go through the JAX traversal (backends ``ref``,
``packed`` and the Pallas kernel in interpret mode) and through
``repro_torch.kernels.ops.traverse_chunk`` on CPU tensors, which runs
the plain PyTorch version.  Per-tree leaf values are pure selects, so
the contract is bit-identity (``np.array_equal``), NaN rows included: a
one-ulp difference is a bug, never a tolerance.

The forest-sum form (``ops.forest_sum``; on the CPU ``ref.forest_sum_ref``)
is held the same way against the JAX engine's whole ensemble sum,
``repro.core.predict._forest_sum``: the same float32 adds in tree order,
bit for bit, at tree counts on either side of the JAX chunk of 25 (the
JAX engine pads with zero trees, the port does not).

The CUDA kernels themselves are held against the plain versions on the
card by tests/test_torch_cuda.py.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import predict as jpredict
from repro.kernels import ref as jref
from repro.kernels.ops import TraverseSpec as JTraverseSpec
from repro.kernels.traverse import traverse_chunk_pallas
from repro.launch.serve_gbdt import synthetic_gbdt
from repro_torch.kernels import ops, ref, traverse

# the pinned fixture of tests/test_predict_engine.py
N_TREES, DEPTH, F, K = 13, 4, 6, 8


@pytest.fixture(scope="module")
def jmodel():
    return synthetic_gbdt(n_trees=N_TREES, max_depth=DEPTH, n_features=F,
                          n_candidates=K, seed=7, passthrough_frac=0.25)


@pytest.fixture(scope="module")
def x_nan():
    rng = np.random.default_rng(42)
    x = rng.normal(size=(97, F)).astype(np.float32)
    x[::11, 0] = np.nan
    x[5, :] = np.nan
    return x


def _jax_traverse(backend, values, feature, cmp, leaf, max_depth):
    args = tuple(jnp.asarray(a) for a in (values, feature, cmp, leaf))
    if backend == "ref":
        out = jref.traverse_chunk_ref(*args, max_depth=max_depth)
    elif backend == "packed":
        out = jref.traverse_chunk_packed(*args, max_depth=max_depth)
    else:
        out = traverse_chunk_pallas(*args, max_depth=max_depth,
                                    interpret=True)
    return np.asarray(out)


def _torch_traverse(values, feature, cmp, leaf, max_depth, backend="auto"):
    args = tuple(torch.from_numpy(np.ascontiguousarray(a))
                 for a in (values, feature, cmp, leaf))
    spec = ops.TraverseSpec(binned=args[0].dtype == torch.int32,
                            backend=backend)
    return ops.traverse_chunk(*args, spec, max_depth=max_depth).numpy()


def _padded_chunks(jmodel, chunk, binned):
    """The forest cut into chunks, padded with passthrough zero-leaf
    trees exactly as both engines pad it."""
    fo = jmodel.forest
    feat = np.asarray(fo.feature)
    cmp = np.asarray(fo.split_bin if binned else fo.threshold)
    leaf = np.asarray(fo.leaf_value)
    pad = -N_TREES % chunk
    feat = np.pad(feat, ((0, pad), (0, 0)), constant_values=-1)
    cmp = np.pad(cmp, ((0, pad), (0, 0)),
                 constant_values=2 ** 20 if binned else np.inf)
    leaf = np.pad(leaf, ((0, pad), (0, 0)))
    for s in range(0, N_TREES + pad, chunk):
        yield feat[s:s + chunk], cmp[s:s + chunk], leaf[s:s + chunk]


@pytest.mark.parametrize("jax_backend", ["ref", "packed", "interpret"])
@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("chunk", [1, 7, N_TREES])
def test_fixture_chunks_bit_identical(jmodel, x_nan, jax_backend, binned,
                                      chunk):
    values = (np.asarray(jmodel.bin_features(jnp.asarray(x_nan)), np.int32)
              if binned else x_nan)
    for feat, cmp, leaf in _padded_chunks(jmodel, chunk, binned):
        want = _jax_traverse(jax_backend, values, feat, cmp, leaf, DEPTH)
        got = _torch_traverse(values, feat, cmp, leaf, DEPTH)
        assert got.dtype == np.float32 and got.shape == want.shape
        assert np.array_equal(got, want), (jax_backend, binned, chunk)


def _random_chunk(rng, *, n, C, depth, binned, f=5, k=9):
    n_inner = 2 ** depth - 1
    feature = rng.integers(0, f, size=(C, n_inner)).astype(np.int32)
    passthrough = rng.random(size=(C, n_inner)) < 0.2
    feature[passthrough] = -1
    leaf = rng.normal(size=(C, n_inner + 1)).astype(np.float32)
    if binned:
        values = rng.integers(0, k + 1, size=(n, f)).astype(np.int32)
        cmp = rng.integers(0, k, size=(C, n_inner)).astype(np.int32)
        cmp[passthrough] = k
    else:
        values = rng.normal(size=(n, f)).astype(np.float32)
        values[::3, 1] = np.nan
        values[0, :] = np.nan
        cmp = rng.normal(size=(C, n_inner)).astype(np.float32)
        cmp[passthrough] = np.inf
    return values, feature, cmp, leaf


@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("depth", [0, 1, 6])
def test_random_chunk_bit_identical(binned, depth):
    """Depth 0 (a single leaf), 1 and 6, with NaN rows on the raw path."""
    rng = np.random.default_rng(100 + depth)
    chunk = _random_chunk(rng, n=33, C=4, depth=depth, binned=binned)
    want = _jax_traverse("ref", *chunk, depth)
    got = _torch_traverse(*chunk, depth)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("binned", [False, True])
def test_out_of_range_feature_ids_follow_jax_gather(binned):
    """An id past the last feature reads the JAX gather's fill value
    (NaN / most negative int); ids below -1 clip to feature 0."""
    rng = np.random.default_rng(7)
    values, feature, cmp, leaf = _random_chunk(rng, n=40, C=5, depth=4,
                                               binned=binned)
    feature[:, ::3] = rng.integers(5, 9, size=feature[:, ::3].shape)
    feature[:, 1::4] = -3
    want = _jax_traverse("ref", values, feature, cmp, leaf, 4)
    got = _torch_traverse(values, feature, cmp, leaf, 4)
    assert np.array_equal(got, want)


def test_raw_nan_routes_right():
    """An all-NaN row fails every ``x <= thr``: it lands in the last leaf
    of a tree without passthrough nodes."""
    depth = 3
    feature = np.zeros((2, 7), np.int32)
    cmp = np.zeros((2, 7), np.float32)
    leaf = np.arange(16, dtype=np.float32).reshape(2, 8)
    x = np.full((1, 2), np.nan, np.float32)
    got = _torch_traverse(x, feature, cmp, leaf, depth)
    assert np.array_equal(got, [[7.0, 15.0]])


def test_auto_on_cpu_resolves_to_ref():
    assert ops.resolve("auto", torch.device("cpu")) == "ref"
    assert ops.resolve("auto", torch.device("cuda")) == "cuda"


@pytest.mark.parametrize("backend,device", [("cuda", "cpu"), ("ref", "cuda")])
def test_backend_on_wrong_device_raises(backend, device):
    with pytest.raises(ValueError):
        ops.resolve(backend, torch.device(device))


@pytest.mark.parametrize("jax_name,port_name", [
    ("pallas", "cuda"), ("interpret", "ref"), ("packed", "ref"),
    ("auto", "auto"), ("cuda", "cuda"), ("ref", "ref")])
def test_jax_backend_names_map(jax_name, port_name):
    assert ops.backend_name(jax_name) == port_name
    assert ops.TraverseSpec(backend=jax_name).backend == port_name


def test_unknown_backend_and_bad_chunk_raise():
    with pytest.raises(ValueError):
        ops.TraverseSpec(backend="triton")
    with pytest.raises(ValueError):
        ops.TraverseSpec(tree_chunk=0)


def test_cuda_backend_on_cpu_tensor_raises(x_nan, jmodel):
    feat, cmp, leaf = next(_padded_chunks(jmodel, 7, False))
    before = traverse.launches
    with pytest.raises(ValueError):
        _torch_traverse(x_nan, feat, cmp, leaf, DEPTH, backend="cuda")
    with pytest.raises(ValueError, match="CUDA device"):
        traverse.traverse_chunk_cuda(
            *(torch.from_numpy(np.ascontiguousarray(a))
              for a in (x_nan, feat, cmp, leaf)), max_depth=DEPTH)
    assert traverse.launches == before


# -- the forest-sum form -------------------------------------------------------

def _jax_forest_sum(forest, values, backend, binned):
    spec = JTraverseSpec(tree_chunk=25, binned=binned, backend=backend)
    n = values.shape[0]
    return np.asarray(jpredict._forest_sum(
        forest, jnp.asarray(values), jnp.zeros((n,), jnp.float32),
        max_depth=DEPTH, spec=spec.resolved()))


def _torch_forest(forest, binned):
    fo = [torch.from_numpy(np.array(getattr(forest, k))) for k in
          ("feature", "split_bin" if binned else "threshold", "leaf_value")]
    return fo


@pytest.mark.parametrize("jax_backend", ["ref", "interpret"])
@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("n_trees", [1, 24, 25, 26, 500])
def test_forest_sum_equals_jax_engine(x_nan, jax_backend, binned, n_trees):
    """The plain forest sum, at the JAX chunk (25) and another (7), equals
    the JAX engine's chunk-scanned sum bit for bit, raw with NaN rows and
    binned; ``ops.forest_sum`` on CPU tensors is that plain version."""
    jm = synthetic_gbdt(n_trees=n_trees, max_depth=DEPTH, n_features=F,
                        n_candidates=K, seed=n_trees, passthrough_frac=0.25)
    values = (np.asarray(jm.bin_features(jnp.asarray(x_nan)), np.int32)
              if binned else x_nan)
    want = _jax_forest_sum(jm.forest, values, jax_backend, binned)
    feature, cmp, leaf = _torch_forest(jm.forest, binned)
    v = torch.from_numpy(np.ascontiguousarray(values))
    for chunk in (25, 7):
        got = ref.forest_sum_ref(v, feature, cmp, leaf, max_depth=DEPTH,
                                 tree_chunk=chunk)
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want), (chunk, n_trees)
    spec = ops.TraverseSpec(tree_chunk=9, binned=binned)
    assert np.array_equal(ops.forest_sum(v, feature, cmp, leaf, spec,
                                         max_depth=DEPTH).numpy(), want)


@pytest.mark.parametrize("n_trees", [1, 26])
def test_forest_sum_first_leaf_negative_zero(x_nan, n_trees):
    """Every leaf of the first tree is -0.0: the sum starts at +0.0 and
    adds it, as the JAX engine does, so a one-tree forest sums to +0.0
    (sign bit clear), never to the leaf itself."""
    jm = synthetic_gbdt(n_trees=n_trees, max_depth=DEPTH, n_features=F,
                        n_candidates=K, seed=3, passthrough_frac=0.25)
    leaf = np.array(jm.forest.leaf_value)
    leaf[0] = -0.0
    if n_trees > 1:
        leaf[1:4] = -0.0
    forest = jm.forest._replace(leaf_value=jnp.asarray(leaf))
    want = _jax_forest_sum(forest, x_nan, "ref", False)
    feature, cmp, leaf_t = _torch_forest(forest, False)
    got = ref.forest_sum_ref(torch.from_numpy(x_nan), feature, cmp, leaf_t,
                             max_depth=DEPTH).numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    if n_trees == 1:
        assert not np.signbit(got).any()


def test_forest_sum_affine_is_two_roundings(x_nan):
    """``base + scale * sum`` as two float32 operations, what the JAX
    engine's ``margin`` does outside its jit."""
    jm = synthetic_gbdt(n_trees=30, max_depth=DEPTH, n_features=F,
                        n_candidates=K, seed=5, passthrough_frac=0.25)
    total = _jax_forest_sum(jm.forest, x_nan, "ref", False)
    want = np.float32(0.25) + np.float32(0.3) * total
    feature, cmp, leaf = _torch_forest(jm.forest, False)
    got = ref.forest_sum_ref(torch.from_numpy(x_nan), feature, cmp, leaf,
                             max_depth=DEPTH, base=0.25, scale=0.3)
    assert np.array_equal(got.numpy(), want)


def test_forest_sum_takes_no_cpu_tensor(x_nan, jmodel):
    feature, cmp, leaf = _torch_forest(jmodel.forest, False)
    before = traverse.forest_launches
    with pytest.raises(ValueError, match="CUDA device"):
        traverse.forest_sum_cuda(torch.from_numpy(x_nan), feature, cmp, leaf,
                                 max_depth=DEPTH)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.forest_sum(torch.from_numpy(x_nan), feature, cmp, leaf,
                       ops.TraverseSpec(backend="cuda"), max_depth=DEPTH)
    assert traverse.forest_launches == before
