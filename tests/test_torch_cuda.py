"""The port's CUDA kernels on the card (``cuda``-marked; skip without a GPU).

This file imports nothing of JAX, so it also runs on a machine that has
a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version.  Traversal and
split gain: ``torch.equal`` (pure selects; the same float32 operations in
the same order).  Histograms: ``torch.equal`` on integer-valued g/h,
whose float sums are exact in any order below 2^24, and within
``ref.hist_rounding_bound`` on real g/h, since atomics add in no fixed
order.
"""

import numpy as np
import pytest
import torch

from repro_torch import GBDTConfig, fit
from repro_torch.core.proposal import random_candidates
from repro_torch.kernels import hist, ref, split_gain, traverse
from repro_torch.launch.serve_gbdt import synthetic_gbdt


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _chunk(rng, *, n, C, depth, binned, f=32, k=32):
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


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
def test_traverse_kernel_matches_plain_version(cuda, binned):
    """Bit-identical at the serving chunk shape and at ragged sizes; a
    depth-0 chunk returns without a launch."""
    rng = np.random.default_rng(5)
    for n, C, depth in [(1, 1, 1), (4095, 25, 6), (4096, 25, 6),
                        (1000, 7, 3), (64, 25, 0)]:
        chunk = tuple(torch.from_numpy(a).to(cuda) for a in _chunk(
            rng, n=n, C=C, depth=depth, binned=binned))
        before = traverse.launches
        out = traverse.traverse_chunk_cuda(*chunk, max_depth=depth)
        want = ref.traverse_chunk_ref(*chunk, max_depth=depth)
        torch.cuda.synchronize()
        assert torch.equal(out, want), (n, C, depth)
        assert traverse.launches == before + (depth > 0)


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
def test_traverse_kernel_out_of_range_feature_ids(cuda, binned):
    """Ids past the last feature read the fill value, as the plain
    version does, and nothing outside the row."""
    rng = np.random.default_rng(6)
    values, feature, cmp, leaf = _chunk(rng, n=300, C=9, depth=5,
                                        binned=binned)
    feature[:, ::3] = rng.integers(32, 40, size=feature[:, ::3].shape)
    feature[:, 1::4] = -3
    chunk = tuple(torch.from_numpy(a).to(cuda)
                  for a in (values, feature, cmp, leaf))
    out = traverse.traverse_chunk_cuda(*chunk, max_depth=5)
    assert torch.equal(out, ref.traverse_chunk_ref(*chunk, max_depth=5))


@pytest.mark.cuda
def test_traverse_kernel_rejects_what_it_does_not_take(cuda):
    values, feature, cmp, leaf = (torch.from_numpy(a).to(cuda) for a in _chunk(
        np.random.default_rng(0), n=8, C=2, depth=2, binned=False))
    with pytest.raises(TypeError):
        traverse.traverse_chunk_cuda(values, feature, cmp.to(torch.int32),
                                     leaf, max_depth=2)
    with pytest.raises(ValueError):
        traverse.traverse_chunk_cuda(values.T, feature, cmp, leaf,
                                     max_depth=2)
    with pytest.raises(ValueError):
        traverse.traverse_chunk_cuda(values, feature, cmp, leaf, max_depth=3)


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
def test_model_on_card_matches_cpu(cuda, binned):
    """Margins on the card equal the same model's on the CPU bit for bit,
    through the kernel: one launch per chunk of trees."""
    model = synthetic_gbdt(n_trees=60, max_depth=6, n_features=32,
                           n_candidates=32, seed=3, device=cuda)
    x = np.random.default_rng(1).normal(size=(777, 32)).astype(np.float32)
    x[::13, 4] = np.nan
    before = traverse.launches
    got = model.predict(x, output="margin", binned=binned, tree_chunk=25)
    assert traverse.launches == before + 3
    want = model.to("cpu").predict(x, output="margin", binned=binned,
                                   tree_chunk=25)
    assert torch.equal(got.cpu(), want)


# -- training kernels --------------------------------------------------------


def _hist_case(rng, *, n, f, nbins, n_nodes, L, child, integer):
    """Bins, node ids (with masked rows, and ids and bins out of range
    in a few rows) and g/h: integer-valued (exact in any order) or
    real."""
    bins = rng.integers(0, nbins, size=(n, f)).astype(np.int32)
    hi = 2 * n_nodes if child else n_nodes
    node = rng.integers(-1, hi, size=(L, n)).astype(np.int32)
    if n > 10:
        bins[::97, 0] = nbins          # out of range: dropped
        node[:, 5::101] = hi + 3       # out of range: dropped
    if integer:
        gh = rng.integers(-3, 4, size=(n, 2)).astype(np.float32)
        gh[:, 1] = np.abs(gh[:, 1])
    else:
        gh = rng.normal(size=(n, 2)).astype(np.float32)
        gh[:, 1] = np.abs(gh[:, 1])
    return bins, node, gh


HIST_SHAPES = [  # (n, f, nbins, n_nodes, L)
    (1, 1, 2, 1, 1), (4097, 28, 33, 32, 1), (4097, 3, 257, 32, 6),
    (20000, 28, 33, 32, 6), (3000, 5, 9, 1, 3), (5000, 2, 2, 4, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_hist_kernel_matches_plain_version(cuda, child):
    """Integer-valued g/h: float sums are exact in any order (far below
    2^24), so the kernel equals the plain version bit for bit; real g/h:
    within ``ref.hist_rounding_bound``.  One launch a call."""
    rng = np.random.default_rng(11)
    kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
    plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
    for n, f, nbins, n_nodes, L in HIST_SHAPES:
        for integer in (True, False):
            bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
                rng, n=n, f=f, nbins=nbins, n_nodes=n_nodes, L=L,
                child=child, integer=integer))
            kw = dict(n_nodes=n_nodes, nbins=nbins)
            before = (hist.launches, hist.left_launches)
            got = kernel(bins, node, gh, **kw)
            want = plain(bins, node, gh, **kw)
            torch.cuda.synchronize()
            assert (hist.launches, hist.left_launches) == (
                before[0] + (not child), before[1] + child)
            if child:           # the row counts subtraction growth reads
                assert torch.equal(got[1], want[1]), (n, f, nbins, n_nodes, L)
                got, want = got[0], want[0]
            assert got.shape == (L, n_nodes, f, nbins, 2)
            if integer:
                assert torch.equal(got, want), (n, f, nbins, n_nodes, L)
            else:
                bound = ref.hist_rounding_bound(bins, node, gh, child=child,
                                                **kw)
                assert bool(((got.double() - want.double()).abs()
                             <= bound).all()), (n, f, nbins, n_nodes, L)


@pytest.mark.cuda
def test_hist_cuda_is_the_single_level_view(cuda):
    rng = np.random.default_rng(12)
    bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
        rng, n=3000, f=4, nbins=9, n_nodes=4, L=1, child=False,
        integer=True))
    one = hist.hist_cuda(bins, node[0], gh, n_nodes=4, nbins=9)
    assert torch.equal(one, ref.hist_ref(bins, node[0], gh, n_nodes=4,
                                         nbins=9))


@pytest.mark.cuda
def test_hist_kernel_rejects_what_it_does_not_take(cuda):
    bins = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    node = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    gh = torch.ones((8, 2), device=cuda)
    with pytest.raises(TypeError):
        hist.hist_levels_cuda(bins.long(), node, gh, n_nodes=1, nbins=4)
    with pytest.raises(ValueError):
        hist.hist_levels_cuda(bins, node, gh.T, n_nodes=1, nbins=4)
    with pytest.raises(ValueError):
        hist.hist_levels_cuda(bins, node.cpu(), gh, n_nodes=1, nbins=4)
    with pytest.raises(ValueError):
        hist.hist_levels_cuda(bins, node, gh, n_nodes=1, nbins=1 << 20)
    before = hist.launches          # no rows: zeros, and no launch
    empty = hist.hist_levels_cuda(bins[:0], node[:, :0], gh[:0], n_nodes=2,
                                  nbins=4)
    assert hist.launches == before
    assert empty.shape == (1, 2, 2, 4, 2) and not bool(empty.any())


@pytest.mark.cuda
@pytest.mark.parametrize("nbins", [1, 2, 9, 17, 33, 65, 257, 300])
def test_split_gain_kernel_matches_plain_version(cuda, nbins):
    """Bit for bit, empty bins, illegal nodes and NaN gains (l2 = 0,
    min_child_weight = 0) included."""
    rng = np.random.default_rng(nbins)
    h = rng.normal(size=(32, 28, nbins, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1])
    h[rng.random(h.shape[:3]) < 0.3] = 0.0
    h[3] = 0.0
    hist_t = torch.from_numpy(h).to(cuda)
    for l2, gamma, mcw in [(1.0, 0.0, 1e-6), (1.0, 0.1, 1.0),
                           (0.0, 0.0, 0.0), (0.5, 0.3, 0.5)]:
        before = split_gain.launches
        g, i = split_gain.split_gain_cuda(hist_t, l2=l2, gamma=gamma,
                                          min_child_weight=mcw)
        gw, iw = ref.split_gain_ref(hist_t, l2=l2, gamma=gamma,
                                    min_child_weight=mcw)
        torch.cuda.synchronize()
        assert split_gain.launches == before + 1
        torch.testing.assert_close(g, gw, rtol=0, atol=0, equal_nan=True)
        assert torch.equal(i, iw)


@pytest.mark.cuda
@pytest.mark.parametrize("subtract", [False, True])
def test_fit_on_card_matches_cpu(cuda, subtract):
    """A small fit on the card and on the CPU from one injected grid:
    the same trees (structure exact, leaves within 1e-5; the card's
    atomics add in another order), through max_depth histogram and
    max_depth split-gain launches a tree."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    cfg = GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                     subtract=subtract)
    gen = torch.Generator().manual_seed(0)
    grid = torch.stack([random_candidates(gen, torch.from_numpy(x), 16)
                        for _ in range(6)])
    before = (hist.launches + hist.left_launches, split_gain.launches)
    on_card = fit(x, y, cfg, candidates=grid, device=cuda)
    assert (hist.launches + hist.left_launches - before[0],
            split_gain.launches - before[1]) == (6 * 4, 6 * 4)
    on_cpu = fit(x, y, cfg, candidates=grid, device="cpu")
    fa, fb = on_card.forest, on_cpu.forest
    assert torch.equal(fa.feature.cpu(), fb.feature)
    assert torch.equal(fa.split_bin.cpu(), fb.split_bin)
    assert torch.equal(fa.threshold.cpu(), fb.threshold)
    torch.testing.assert_close(fa.leaf_value.cpu(), fb.leaf_value,
                               rtol=0, atol=1e-5)
