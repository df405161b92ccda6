"""Parity of the port's histograms with the JAX package's.

The same numpy inputs go through both on the CPU.  Contracts, with their
reasons:

  * the plain ``hist_levels_ref`` / ``hist_levels_left_ref`` /
    ``hist_ref`` equal the JAX ``ref`` functions bit for bit: CPU
    ``index_add_`` adds each bucket's rows in row order, as the JAX
    scatter does;
  * against the Pallas kernel in interpret mode (a one-hot matmul, which
    sums in another order): within ``ref.hist_rounding_bound``, twice
    the worst-case float32 error of a sum of the bucket's rows;
  * ids out of range (a node id >= n_nodes, a bin outside [0, nbins))
    drop out of the port's histogram; the JAX ``hist_ref`` would alias
    them into a neighbouring bucket, so there the port is held to the
    JAX result on the same rows with those ids masked.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.core import binning as jbinning
from repro.kernels import hist as jhist, ref as jref
from repro_torch.core import binning
from repro_torch.kernels import hist, ops, ref
from repro_torch.kernels.ops import HistSpec


def _case(n, f, nbins, n_nodes, L, seed=0, child=False, p_left=0.5):
    """Bins, node ids with masked (-1) rows and g/h.  With ``child`` the
    ids are child frontier ids ``2 * parent + route`` (route 0 = LEFT)."""
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, nbins, (n, f)).astype(np.int32)
    node = rng.integers(-1, n_nodes, (L, n))
    if child:
        route = (rng.random((L, n)) >= p_left).astype(np.int64)
        node = np.where(node >= 0, 2 * node + route, -1)
    gh = rng.normal(size=(n, 2)).astype(np.float32)
    return bins, node.astype(np.int32), gh


def _left_sums(*args, **kw):
    """The sums of the port's child mode, without its row counts."""
    return ref.hist_levels_left_ref(*args, **kw)[0]


def _both(fn_j, fn_t, bins, node, gh, **kw):
    want = np.asarray(fn_j(jnp.asarray(bins), jnp.asarray(node),
                           jnp.asarray(gh), **kw))
    got = fn_t(torch.from_numpy(bins), torch.from_numpy(node),
               torch.from_numpy(gh), **kw)
    assert got.dtype == torch.float32
    return got.numpy(), want


@pytest.mark.parametrize("nbins", [2, 9, 33])
@pytest.mark.parametrize("n_nodes", [1, 4])
@pytest.mark.parametrize("L", [1, 3])
def test_hist_levels_ref_bit_equal(L, n_nodes, nbins):
    bins, node, gh = _case(700, 5, nbins, n_nodes, L, seed=L * 100 + nbins)
    got, want = _both(jref.hist_levels_ref, ref.hist_levels_ref, bins, node,
                      gh, n_nodes=n_nodes, nbins=nbins)
    assert got.shape == (L, n_nodes, 5, nbins, 2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("nbins", [2, 9, 33])
@pytest.mark.parametrize("n_nodes", [1, 4])
@pytest.mark.parametrize("L", [1, 3])
def test_hist_levels_left_ref_bit_equal(L, n_nodes, nbins):
    """Odd (routed right) and negative child ids drop out; even ids add
    into their parent's bucket."""
    bins, node, gh = _case(700, 5, nbins, n_nodes, L, seed=L * 10 + nbins,
                           child=True)
    assert (node % 2 == 1).any() and (node % 2 == 0).any()
    got, want = _both(jref.hist_levels_left_ref, _left_sums,
                      bins, node, gh, n_nodes=n_nodes, nbins=nbins)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("p_left", [0.97, 1.0])
def test_hist_levels_left_passthrough_heavy(p_left):
    """Routing where (nearly) every node is a passthrough: all rows go
    left, the right children are empty."""
    bins, node, gh = _case(900, 3, 9, 4, 3, seed=7, child=True,
                           p_left=p_left)
    got, want = _both(jref.hist_levels_left_ref, _left_sums,
                      bins, node, gh, n_nodes=4, nbins=9)
    assert np.array_equal(got, want)


def test_hist_ref_single_level_bit_equal():
    bins, node, gh = _case(300, 4, 9, 6, 1, seed=2)
    got, want = _both(jref.hist_ref, ref.hist_ref, bins, node[0], gh,
                      n_nodes=6, nbins=9)
    assert got.shape == (6, 4, 9, 2)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_against_pallas_interpret_within_bound(child):
    bins, node, gh = _case(257, 3, 8, 4, 2, seed=12, child=child)
    fn = jhist.hist_levels_left_pallas if child else jhist.hist_levels_pallas
    want = np.asarray(fn(jnp.asarray(bins), jnp.asarray(node),
                         jnp.asarray(gh), n_nodes=4, nbins=8,
                         interpret=True))
    args = (torch.from_numpy(bins), torch.from_numpy(node),
            torch.from_numpy(gh))
    plain = _left_sums if child else ref.hist_levels_ref
    got = plain(*args, n_nodes=4, nbins=8).numpy()
    bound = ref.hist_rounding_bound(*args, n_nodes=4, nbins=8,
                                    child=child).numpy()
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_rounding_bound_is_zero_for_single_rows():
    bins = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    node = torch.tensor([[0, 1]], dtype=torch.int32)
    gh = torch.tensor([[0.5, 1.0], [-2.0, 3.0]])
    bound = ref.hist_rounding_bound(bins, node, gh, n_nodes=2, nbins=2)
    assert float(bound.max()) == 0.0
    node = torch.tensor([[0, 0]], dtype=torch.int32)
    bound = ref.hist_rounding_bound(bins, node, gh, n_nodes=1, nbins=2)
    # bucket (feature 1, bin 1) holds two rows
    assert float(bound[0, 0, 1, 1, 0]) == pytest.approx(2 * 2.5 * 2 ** -24)


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_out_of_range_ids_drop_out(child):
    """A bin id outside [0, nbins) or a node id past the panel adds
    nothing: the result is the JAX one on the same rows with those ids
    masked."""
    n_nodes, nbins = 4, 9
    bins, node, gh = _case(500, 3, nbins, n_nodes, 2, seed=5, child=child)
    hi = 2 * n_nodes if child else n_nodes
    bad_bins, bad_node = bins.copy(), node.copy()
    bad_bins[::7, 1] = nbins
    bad_bins[3::11, 2] = -2
    bad_node[:, 5::13] = hi + np.array([[0], [5]])
    masked_node = np.where(bad_node >= hi, -1, bad_node).astype(np.int32)
    jfn = jref.hist_levels_left_ref if child else jref.hist_levels_ref
    tfn = _left_sums if child else ref.hist_levels_ref
    got, _ = _both(jfn, tfn, bad_bins, bad_node, gh, n_nodes=n_nodes,
                   nbins=nbins)
    # the JAX result per feature, with the rows of a bad bin masked
    for j in range(3):
        keep = (bad_bins[:, j] >= 0) & (bad_bins[:, j] < nbins)
        nj = np.where(keep[None, :], masked_node, -1).astype(np.int32)
        want = np.asarray(jfn(jnp.asarray(bad_bins.clip(0, nbins - 1)),
                              jnp.asarray(nj), jnp.asarray(gh),
                              n_nodes=n_nodes, nbins=nbins))
        assert np.array_equal(got[:, :, j], want[:, :, j])


def test_ops_hist_levels_dispatch_and_checks():
    bins, node, gh = (torch.from_numpy(a) for a in _case(200, 3, 9, 4, 2))
    spec = HistSpec(n_nodes=4, nbins=9, n_levels=2)
    assert torch.equal(ops.hist_levels(bins, node, gh, spec),
                       ref.hist_levels_ref(bins, node, gh, n_nodes=4,
                                           nbins=9))
    child = ops.hist_levels(bins, node, gh, spec.child_view())
    want = ref.hist_levels_left_ref(bins, node, gh, n_nodes=2, nbins=9)
    assert all(torch.equal(a, b) for a, b in zip(child, want))
    for backend in ("ref", "interpret", "packed"):       # JAX names map
        out = ops.hist_levels(bins, node, gh,
                              dataclasses.replace(spec, backend=backend))
        assert torch.equal(out, ops.hist_levels(bins, node, gh, spec))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.hist_levels(bins, node, gh,
                        dataclasses.replace(spec, backend="cuda"))
    with pytest.raises(ValueError):                 # node has 2 levels
        ops.hist_levels(bins, node, gh, spec.with_levels(3))


def test_histspec_validation_and_views():
    for bad in (dict(n_nodes=0, nbins=4), dict(n_nodes=2, nbins=0),
                dict(n_nodes=2, nbins=4, n_levels=0),
                dict(n_nodes=2, nbins=4, backend="tpu"),
                dict(n_nodes=2, nbins=4, acc_dtype="bfloat16")):
        with pytest.raises(ValueError):
            HistSpec(**bad)
    spec = HistSpec(n_nodes=8, nbins=4, n_levels=3, backend="pallas")
    assert spec.backend == "cuda"
    assert spec.with_levels(1).n_levels == 1
    assert spec.with_levels(1).n_nodes == 8
    cv = spec.child_view()
    assert cv.n_nodes == 4 and cv.subtract is True
    assert HistSpec(n_nodes=1, nbins=4).child_view().n_nodes == 1
    assert hash(spec) == hash(HistSpec(n_nodes=8, nbins=4, n_levels=3,
                                       backend="cuda"))


def test_bin_counts_matches_jax():
    rng = np.random.default_rng(4)
    bins = rng.integers(0, 9, (300, 5)).astype(np.int32)
    want = np.asarray(jbinning.bin_counts(jnp.asarray(bins), 9))
    got = binning.bin_counts(torch.from_numpy(bins), 9)
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)


def test_kernel_wrappers_take_no_cpu_tensor():
    """The CUDA wrappers never fall back: a CPU tensor raises before any
    build or launch, and the counters stay put."""
    from repro_torch.kernels import hist
    bins, node, gh = (torch.from_numpy(a) for a in _case(50, 2, 4, 2, 1))
    before = (hist.launches, hist.left_launches)
    for fn in (hist.hist_levels_cuda, hist.hist_levels_left_cuda):
        with pytest.raises(ValueError, match="is on cpu"):
            fn(bins, node, gh, n_nodes=2, nbins=4)
    with pytest.raises(ValueError, match="is on cpu"):
        hist.hist_cuda(bins, node[0], gh, n_nodes=2, nbins=4)
    assert (hist.launches, hist.left_launches) == before


@pytest.mark.parametrize("L,n_nodes,nbins", [(1, 1, 2), (3, 4, 9)])
def test_child_mode_counts_rows(L, n_nodes, nbins):
    """Child mode also returns the rows of each bucket: the left rows
    (even child ids), keyed by parent, ids out of range dropped."""
    bins, node, gh = _case(600, 3, nbins, n_nodes, L, seed=9, child=True)
    node[:, ::50] = 2 * n_nodes + 2
    args = (torch.from_numpy(bins), torch.from_numpy(node),
            torch.from_numpy(gh))
    panel, counts = ref.hist_levels_left_ref(*args, n_nodes=n_nodes,
                                             nbins=nbins)
    masked = np.where(node >= 2 * n_nodes, -1, node).astype(np.int32)
    assert np.array_equal(panel.numpy(), np.asarray(jref.hist_levels_left_ref(
        jnp.asarray(bins), jnp.asarray(masked), jnp.asarray(gh),
        n_nodes=n_nodes, nbins=nbins)))
    want = np.zeros((L, n_nodes, 3, nbins), np.int32)
    for lvl in range(L):
        for r in range(600):
            c = node[lvl, r]
            if 0 <= c < 2 * n_nodes and c % 2 == 0:
                for j in range(3):
                    want[lvl, c // 2, j, bins[r, j]] += 1
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), want)
    spec = HistSpec(n_nodes=n_nodes, nbins=nbins, n_levels=L, subtract=True)
    got = ops.hist_levels(*args, spec)
    assert torch.equal(got[0], panel) and torch.equal(got[1], counts)
