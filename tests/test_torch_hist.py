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


# -- the CUDA kernel's fixed-point arithmetic, emulated on the CPU -----------
#
# The card's histogram sums int64 multiples of a launch-wide quantum
# (``ref.hist_levels_fixed`` is its arithmetic, bit for bit): integer adds
# are the same in any order, so the result repeats; each term is rounded
# to the quantum and the sum once to float32, so it lies within
# ``hist_rounding_bound(..., quantum=ref.hist_quanta(gh))`` of the plain
# row-order sum.

def _tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fixed_point_ignores_the_order_of_rows(child, seed):
    bins, node, gh = _tensors(*_case(3000, 4, 9, 4, 2, seed=seed,
                                     child=child))
    kw = dict(n_nodes=4, nbins=9, child=child)
    want = ref.hist_levels_fixed(bins, node, gh, **kw)
    perm = torch.randperm(3000, generator=torch.Generator().manual_seed(seed))
    got = ref.hist_levels_fixed(bins[perm], node[:, perm], gh[perm], **kw)
    if child:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert torch.equal(got, want)


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
@pytest.mark.parametrize("L,n_nodes,nbins", [(1, 1, 2), (3, 4, 9),
                                             (2, 6, 33)])
def test_fixed_point_equals_plain_on_integer_gh(child, L, n_nodes, nbins):
    """Integer-valued g/h lie on the grid and their sums stay below 2^24:
    the fixed-point sum is the plain version's, bit for bit (counts too)."""
    bins, node, _ = _case(1500, 5, nbins, n_nodes, L, seed=nbins,
                          child=child)
    rng = np.random.default_rng(L)
    gh = rng.integers(-3, 4, size=(1500, 2)).astype(np.float32)
    gh[:, 1] = np.abs(gh[:, 1])
    args = _tensors(bins, node, gh)
    kw = dict(n_nodes=n_nodes, nbins=nbins)
    got = ref.hist_levels_fixed(*args, **kw, child=child)
    want = (ref.hist_levels_left_ref if child else ref.hist_levels_ref)(
        *args, **kw)
    if child:
        assert torch.equal(got[1], want[1])
        got, want = got[0], want[0]
    assert torch.equal(got, want)


def _assert_within_restated_bound(bins, node, gh, *, n_nodes, nbins, child):
    args = (bins, node, gh)
    kw = dict(n_nodes=n_nodes, nbins=nbins)
    got = ref.hist_levels_fixed(*args, **kw, child=child)
    plain = (_left_sums if child else ref.hist_levels_ref)(*args, **kw)
    if child:
        got = got[0]
    bound = ref.hist_rounding_bound(*args, **kw, child=child,
                                    quantum=ref.hist_quanta(gh))
    diff = (got.double() - plain.double()).abs()
    assert bool((diff <= bound).all()), float((diff - bound).max())
    # and against the exact sum (float64: these sums have few terms of
    # 24 bits): within the fixed-point part of the bound
    parent = ref._parent_ids(node) if child else node
    key, valid = ref._bucket_keys(bins, parent, n_nodes, nbins)
    L, n = parent.shape
    exact = torch.zeros((got.numel() // 2, 2), dtype=torch.float64)
    exact.index_add_(0, key[valid], gh.double()[None, :, None, :].expand(
        L, n, bins.shape[1], 2)[valid])
    exact = exact.reshape(got.shape)
    m = ref.hist_levels_ref(bins, parent, torch.ones_like(gh), **kw).double()
    half = m * ref.hist_quanta(gh).double() / 2
    assert bool(((got.double() - exact).abs()
                 <= half + 2.0 ** -24 * (exact.abs() + half)).all())


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
@pytest.mark.parametrize("nbins", [2, 9, 33])
@pytest.mark.parametrize("n_nodes", [1, 4])
@pytest.mark.parametrize("L", [1, 3])
def test_fixed_point_within_restated_bound(child, L, n_nodes, nbins):
    """The pinned workloads of the bit-equality tests above."""
    seed = L * (10 if child else 100) + nbins
    bins, node, gh = _tensors(*_case(700, 5, nbins, n_nodes, L, seed=seed,
                                     child=child))
    _assert_within_restated_bound(bins, node, gh, n_nodes=n_nodes,
                                  nbins=nbins, child=child)


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_fixed_point_single_row_buckets_near_the_quantum(child):
    """Buckets of one row whose values lie near max|x| * 2^-20, beside
    one row at the maximum: single-row buckets have a plain bound of 0,
    and there the fixed-point part of the bound is all there is."""
    rng = np.random.default_rng(8)
    n, f = 64, 3
    bins = np.arange(n * f, dtype=np.int32).reshape(n, f) % 257
    node = np.zeros((1, n), np.int32)
    gh = (rng.normal(size=(n, 2)) * 2.0 ** -20).astype(np.float32)
    gh[0] = [3.0, 5.0]
    gh[1] = [2.0 ** -20 * 3.0 * (1 + 2.0 ** -23), 2.0 ** -21]
    bins, node, gh = _tensors(bins, node, gh)
    plain_bound = ref.hist_rounding_bound(bins, node, gh, n_nodes=1,
                                          nbins=257, child=child)
    assert float(plain_bound.max()) == 0.0
    _assert_within_restated_bound(bins, node, gh, n_nodes=1, nbins=257,
                                  child=child)


def test_fixed_point_scale_never_overflows():
    """n = 2^24 rows, all at max|x| = 2^20 and just below 2^21: the int64
    sums stay within 2^62 and come back exact (a sum of 2^24 equal
    powers of two, or within one float32 rounding of it)."""
    n = 2 ** 24
    bins = torch.zeros((n, 1), dtype=torch.int32)
    node = torch.zeros((1, n), dtype=torch.int32)
    for top in (2.0 ** 20, float(np.nextafter(np.float32(2 ** 21),
                                             np.float32(0)))):
        gh = torch.full((n, 2), top, dtype=torch.float32)
        s = ref.hist_shifts(gh)
        assert n * top * 2.0 ** float(s[0]) < 2.0 ** 62
        got = ref.hist_levels_fixed(bins, node, gh, n_nodes=1, nbins=1)
        want = np.float32(np.float64(n) * top)
        assert float(got[0, 0, 0, 0, 0]) == want, (top, float(s[0]))
        assert float(got[0, 0, 0, 0, 1]) == want
        del gh, got


def test_fixed_point_non_finite_makes_its_column_nan():
    """A NaN or inf g (or h) in any row: every g (or h) sum is NaN, so the
    histogram is never finite where the plain version's is not; the
    other column is unchanged."""
    bins, node, gh = _tensors(*_case(400, 3, 9, 4, 1, seed=3))
    node[:, 5] = 0                     # the row made non-finite adds
    kw = dict(n_nodes=4, nbins=9)
    clean = ref.hist_levels_fixed(bins, node, gh, **kw)
    for col, bad in ((0, float("nan")), (1, float("inf")),
                     (0, float("-inf"))):
        g = gh.clone()
        g[5, col] = bad
        got = ref.hist_levels_fixed(bins, node, g, **kw)
        assert bool(torch.isnan(got[..., col]).all())
        assert torch.equal(got[..., 1 - col], clean[..., 1 - col])
        plain = ref.hist_levels_ref(bins, node, g, **kw)
        assert not bool(torch.isfinite(plain[..., col]).all())


def test_rounding_bound_at_quantum_zero_is_unchanged():
    bins, node, gh = _tensors(*_case(600, 4, 9, 4, 2, seed=4))
    kw = dict(n_nodes=4, nbins=9)
    abs_sum = ref.hist_levels_ref(bins, node, gh.abs(), **kw).double()
    m = ref.hist_levels_ref(bins, node, torch.ones_like(gh), **kw).double()
    gamma = (m - 1).clamp(min=0) * 2.0 ** -24
    want = 2 * gamma / (1 - gamma) * abs_sum
    assert torch.equal(ref.hist_rounding_bound(bins, node, gh, **kw), want)
    assert torch.equal(ref.hist_rounding_bound(bins, node, gh, **kw,
                                               quantum=0), want)
    q = ref.hist_quanta(gh)
    wider = ref.hist_rounding_bound(bins, node, gh, **kw, quantum=q)
    assert bool((wider >= want).all()) and bool((wider > want).any())


@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_fixed_point_against_pallas_interpret_within_bound(child):
    bins, node, gh = _case(257, 3, 8, 4, 2, seed=12, child=child)
    fn = jhist.hist_levels_left_pallas if child else jhist.hist_levels_pallas
    want = np.asarray(fn(jnp.asarray(bins), jnp.asarray(node),
                         jnp.asarray(gh), n_nodes=4, nbins=8,
                         interpret=True))
    args = _tensors(bins, node, gh)
    got = ref.hist_levels_fixed(*args, n_nodes=4, nbins=8, child=child)
    got = (got[0] if child else got).numpy()
    bound = ref.hist_rounding_bound(*args, n_nodes=4, nbins=8, child=child,
                                    quantum=ref.hist_quanta(args[2])).numpy()
    assert (np.abs(got.astype(np.float64) - want) <= bound).all()


def test_hist_shifts_follow_rows_and_maxima():
    gh = torch.tensor([[0.5, 0.0], [-3.0, 0.0]])
    # n = 2 -> N = 1; max|g| = 3 < 2^2 -> s = 62 - 1 - 2; h all zero: the
    # exponent field counts as 1 (E = -125), s capped at 100
    assert ref.hist_shifts(gh).tolist() == [59, 100]
    assert ref.hist_quanta(gh).tolist() == [2.0 ** -59, 2.0 ** -100]
    assert ref.hist_shifts(gh.repeat(3, 1)).tolist() == [62 - 3 - 2, 100]
