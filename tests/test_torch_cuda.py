"""The port's CUDA kernels on the card (``cuda``-marked; skip without a GPU).

This file imports nothing of JAX, so it also runs on a machine that has
a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version.  Traversal (both
forms) and split gain: ``torch.equal`` (pure selects; the same float32
operations in the same order).  Histograms: the kernel sums in fixed point, so it is
``torch.equal`` to ``ref.hist_levels_fixed`` (the same arithmetic in
plain PyTorch) on every input and to itself from launch to launch;
against the plain version ``torch.equal`` on integer-valued g/h, whose
sums are exact below 2^24, and within ``ref.hist_rounding_bound(...,
quantum=ref.hist_quanta(gh))`` on real g/h.  Flash attention: float32 within 2e-4 abs and rel (the JAX
package's tolerance for its kernel against its oracle); bf16 within that
plus one bf16 rounding step (2^-7 of the value), since kernel and plain
version each round a float32 result of their own order of adds, plus
``ref.attention_rounding_bound``, since the Hopper kernel rounds P to
bf16 before its product with V (the float32 plain version does not).

The proposal strategies and the trainer around the kernels: the card's
weighted-quantile and uniform-range grids are the CPU port's bit for bit
(any NaN equal to any NaN), a small fit per strategy meets the forest
contract against the CPU, and telemetry and ``fit_reference`` leave the
forest as it is.

The distributed trainer: the histogram kernel on a grid shared with
other ranks (``bits``, ``log2n``) and with raw int64 sums is
``torch.equal`` to ``ref.hist_levels_fixed`` given the same, and raw sums
of parts of the rows add up to one launch's; a fit on 2 ranks (gloo over
CUDA tensors) equals the fit on 1 (NCCL) in every field; sharded serving
gives the unsharded margins.  The ranks are started by
``launch.distributed.run`` from functions at the top of this file.

Decode and the moe family: SMOKE decode (dense and moe, with and without
a ring buffer) and the MoE layer on the card against the CPU, float32,
within 2e-4; ``sort`` dispatch equal to ``onehot`` on the card where
nothing is dropped.

The ssm and hybrid families: the Mamba2, mLSTM and sLSTM blocks (the
full-sequence layer and the decode step) and SMOKE xlstm-125m and
zamba2-2.7b decode on the card against the CPU, float32, within 2e-4 in
the outputs and the states; their bf16 prefill within 3e-2.
"""

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from repro_torch import GBDTConfig, fit, fit_reference
from repro_torch.core.boosting import leaf_rounding
from repro_torch.checkpoint.npz import flat_state
from repro_torch.configs import get_config
from repro_torch.core import proposal, sketch
from repro_torch.core.proposal import random_candidates
from repro_torch.kernels import flash_attention as flash, hist, ops, ref, \
    split_gain, traverse
from repro_torch.launch import serve
from repro_torch.launch.serve_gbdt import synthetic_gbdt
from repro_torch.launch.steps import make_prefill_step
from repro_torch.models import init_decode_state, init_params, moe, ssm


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
    through the forest-sum kernel: one launch a request, whatever the
    tree chunk, and no per-tree launch."""
    model = synthetic_gbdt(n_trees=60, max_depth=6, n_features=32,
                           n_candidates=32, seed=3, device=cuda)
    x = np.random.default_rng(1).normal(size=(777, 32)).astype(np.float32)
    x[::13, 4] = np.nan
    before = traverse.launches, traverse.forest_launches
    got = model.predict(x, output="margin", binned=binned, tree_chunk=25)
    assert (traverse.launches, traverse.forest_launches) == (
        before[0], before[1] + 1)
    want = model.to("cpu").predict(x, output="margin", binned=binned,
                                   tree_chunk=25)
    assert torch.equal(got.cpu(), want)


def _forest(rng, *, n, T, depth, binned, f=32, out_of_range=False):
    values, feature, cmp, leaf = _chunk(rng, n=n, C=T, depth=depth,
                                        binned=binned, f=f)
    if out_of_range:
        feature[:, ::3] = rng.integers(f, f + 8, size=feature[:, ::3].shape)
        feature[:, 1::4] = -3
    return tuple(torch.from_numpy(a).to("cuda")
                 for a in (values, feature, cmp, leaf))


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
@pytest.mark.parametrize("depth", [0, 1, 6])
def test_forest_sum_kernel_matches_plain_version(cuda, binned, depth):
    """Bit for bit the plain version at tree counts on either side of a
    chunk of 25, and at 500, with NaN rows, passthrough nodes and
    out-of-range feature ids; one launch a call."""
    rng = np.random.default_rng(20 + depth)
    for n, T in [(1, 1), (33, 24), (4096, 25), (4095, 26), (4096, 500)]:
        args = _forest(rng, n=n, T=T, depth=depth, binned=binned,
                       out_of_range=T == 26)
        before = traverse.forest_launches
        got = traverse.forest_sum_cuda(*args, max_depth=depth)
        want = ref.forest_sum_ref(*args, max_depth=depth)
        torch.cuda.synchronize()
        assert traverse.forest_launches == before + 1
        assert got.shape == (n,) and torch.equal(got, want), (n, T)


@pytest.mark.cuda
@pytest.mark.parametrize("binned", [False, True])
def test_forest_sum_kernel_affine_deep_and_wide(cuda, binned):
    """``base + scale * sum`` as two roundings; a depth-13 forest (one
    tree a stage) and 600 features (values read from global memory), bit
    for bit the plain version."""
    rng = np.random.default_rng(30)
    for kw, affine in [(dict(n=1000, T=40, depth=6), dict(base=0.25,
                                                          scale=0.3)),
                       (dict(n=300, T=5, depth=13, f=8), {}),
                       (dict(n=500, T=70, depth=5, f=600),
                        dict(base=-2.0, scale=0.05))]:
        args = _forest(rng, binned=binned, **kw)
        got = traverse.forest_sum_cuda(*args, max_depth=kw["depth"], **affine)
        want = ref.forest_sum_ref(*args, max_depth=kw["depth"], **affine)
        assert torch.equal(got, want), kw


@pytest.mark.cuda
def test_forest_sum_kernel_first_leaf_negative_zero(cuda):
    """A one-tree forest of -0.0 leaves sums to +0.0: the accumulator
    starts at +0.0 and adds the leaf, as the JAX engine does; and a
    repeated launch gives the same bits."""
    rng = np.random.default_rng(31)
    values, feature, cmp, leaf = _forest(rng, n=100, T=1, depth=4,
                                         binned=False)
    leaf = torch.full_like(leaf, -0.0)
    got = traverse.forest_sum_cuda(values, feature, cmp, leaf, max_depth=4)
    assert torch.equal(got, torch.zeros_like(got))
    assert not bool(torch.signbit(got).any())
    args = _forest(rng, n=4096, T=500, depth=6, binned=False)
    assert torch.equal(traverse.forest_sum_cuda(*args, max_depth=6),
                       traverse.forest_sum_cuda(*args, max_depth=6))


@pytest.mark.cuda
def test_forest_sum_kernel_rejects_what_it_does_not_take(cuda):
    values, feature, cmp, leaf = _forest(np.random.default_rng(0), n=8, T=2,
                                         depth=2, binned=False)
    before = traverse.forest_launches
    with pytest.raises(TypeError):
        traverse.forest_sum_cuda(values, feature, cmp.to(torch.int32), leaf,
                                 max_depth=2)
    with pytest.raises(ValueError):
        traverse.forest_sum_cuda(values.T, feature, cmp, leaf, max_depth=2)
    with pytest.raises(ValueError):
        traverse.forest_sum_cuda(values, feature, cmp, leaf, max_depth=3)
    deep = 2 ** (traverse.MAX_FOREST_DEPTH + 1)
    with pytest.raises(ValueError, match="beyond the kernel"):
        traverse.forest_sum_cuda(
            values, torch.zeros((1, deep - 1), dtype=torch.int32, device=cuda),
            torch.zeros((1, deep - 1), device=cuda),
            torch.zeros((1, deep), device=cuda),
            max_depth=traverse.MAX_FOREST_DEPTH + 1)
    assert traverse.forest_launches == before
    empty = traverse.forest_sum_cuda(values[:0], feature, cmp, leaf,
                                     max_depth=2)
    assert empty.shape == (0,) and traverse.forest_launches == before


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
    """Integer-valued g/h: sums are exact (far below 2^24), so the
    kernel equals the plain version bit for bit; real g/h: within
    ``ref.hist_rounding_bound`` restated for the kernel's quantum.  One
    launch a call."""
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
                bound = ref.hist_rounding_bound(
                    bins, node, gh, child=child, **kw,
                    quantum=ref.hist_quanta(gh))
                assert bool(((got.double() - want.double()).abs()
                             <= bound).all()), (n, f, nbins, n_nodes, L)


@pytest.mark.cuda
@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_hist_kernel_equals_its_fixed_point_emulation(cuda, child):
    """Bit for bit ``ref.hist_levels_fixed`` (run on the card), on real
    and integer g/h, at every shape, 257 bins at 32 nodes and 6 levels
    included; row counts too."""
    rng = np.random.default_rng(13)
    kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
    for n, f, nbins, n_nodes, L in HIST_SHAPES:
        for integer in (True, False):
            bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
                rng, n=n, f=f, nbins=nbins, n_nodes=n_nodes, L=L,
                child=child, integer=integer))
            kw = dict(n_nodes=n_nodes, nbins=nbins)
            got = kernel(bins, node, gh, **kw)
            want = ref.hist_levels_fixed(bins, node, gh, **kw, child=child)
            torch.cuda.synchronize()
            if child:
                assert torch.equal(got[1], want[1]), (n, f, nbins, n_nodes, L)
                got, want = got[0], want[0]
            assert torch.equal(got, want), (n, f, nbins, n_nodes, L, integer)


@pytest.mark.cuda
@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_hist_kernel_repeats(cuda, child):
    """Two launches on the same inputs return the same bits, at the
    training shape's width (28 features, 33 bins, 32 nodes)."""
    rng = np.random.default_rng(14)
    bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
        rng, n=300_000, f=28, nbins=33, n_nodes=32, L=1, child=child,
        integer=False))
    kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
    kw = dict(n_nodes=16 if child else 32, nbins=33)
    first = kernel(bins, node, gh, **kw)
    second = kernel(bins, node, gh, **kw)
    torch.cuda.synchronize()
    if child:
        assert torch.equal(first[1], second[1])
        first, second = first[0], second[0]
    assert torch.equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_hist_kernel_non_finite_gh(cuda, child):
    """A NaN g or an inf h in one row: that column is NaN in every bucket
    (the emulation's rule), never finite where the plain version is not;
    the other column stays exact."""
    rng = np.random.default_rng(15)
    kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
    plain = ref.hist_levels_left_ref if child else ref.hist_levels_ref
    bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
        rng, n=5000, f=4, nbins=9, n_nodes=4, L=2, child=child,
        integer=False))
    kw = dict(n_nodes=4, nbins=9)
    for col, bad in ((0, float("nan")), (1, float("inf"))):
        g = gh.clone()
        g[7, col] = bad
        node[:, 7] = 0          # row 7 adds at every level, in both modes
        got = kernel(bins, node, g, **kw)
        want = ref.hist_levels_fixed(bins, node, g, **kw, child=child)
        base = plain(bins, node, g, **kw)
        torch.cuda.synchronize()
        if child:
            got, want, base = got[0], want[0], base[0]
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
        assert bool(torch.isnan(got[..., col]).all())
        assert not bool(torch.isfinite(base[..., col]).all())


@pytest.mark.cuda
@pytest.mark.parametrize("child", [False, True], ids=["direct", "left"])
def test_hist_kernel_shared_grid_and_raw_sums(cuda, child):
    """A grid shared with other processes (``bits`` of a larger maximum
    than the launch's own, ``log2n`` of more rows) and the raw int64 sums:
    bit for bit ``ref.hist_levels_fixed`` given the same, finalized or
    raw, counts too; a shared non-finite maximum makes that column NaN
    and leaves the raw sums of the finite column as they are."""
    rng = np.random.default_rng(17)
    kernel = hist.hist_levels_left_cuda if child else hist.hist_levels_cuda
    for n, f, nbins, n_nodes, L in HIST_SHAPES:
        bins, node, gh = (torch.from_numpy(a).to(cuda) for a in _hist_case(
            rng, n=n, f=f, nbins=nbins, n_nodes=n_nodes, L=L, child=child,
            integer=False))
        own = ref.max_bits(gh)
        grids = [(own, ref.log2_ceil(n)),
                 (ref.max_bits(4 * gh), ref.log2_ceil(n) + 3),
                 (torch.stack([own[0], torch.tensor(
                     ref.NONFINITE_BITS + 0x400000, device=cuda,
                     dtype=torch.int32)]), ref.log2_ceil(n) + 1)]
        for bits, log2n in grids:
            for raw in (False, True):
                kw = dict(n_nodes=n_nodes, nbins=nbins, bits=bits,
                          log2n=log2n, raw=raw)
                got = kernel(bins, node, gh, **kw)
                want = ref.hist_levels_fixed(bins, node, gh, child=child,
                                             **kw)
                torch.cuda.synchronize()
                if child:
                    assert torch.equal(got[1], want[1])
                    got, want = got[0], want[0]
                assert got.dtype == (torch.int64 if raw else torch.float32)
                torch.testing.assert_close(got, want, rtol=0, atol=0,
                                           equal_nan=True)
        # the raw sums of all rows, split in two launches on one grid,
        # add up to one launch's
        bits, log2n = ref.max_bits(gh), ref.log2_ceil(n)
        half = n // 2
        kw = dict(n_nodes=n_nodes, nbins=nbins, bits=bits, log2n=log2n,
                  raw=True)
        parts = [kernel(bins[s].contiguous(), node[:, s].contiguous(),
                        gh[s].contiguous(), **kw)
                 for s in (slice(0, half), slice(half, n)) if s.stop > s.start]
        whole = kernel(bins, node, gh, **kw)
        if child:
            assert torch.equal(sum(p[1] for p in parts), whole[1])
            parts, whole = [p[0] for p in parts], whole[0]
        assert torch.equal(sum(parts), whole)


@pytest.mark.cuda
def test_hist_kernel_rejects_a_grid_it_cannot_hold(cuda):
    bins = torch.zeros((8, 2), dtype=torch.int32, device=cuda)
    node = torch.zeros((1, 8), dtype=torch.int32, device=cuda)
    gh = torch.ones((8, 2), device=cuda)
    bits = ref.max_bits(gh)
    with pytest.raises(ValueError, match="log2n"):     # 2^2 < 8 rows
        hist.hist_levels_cuda(bins, node, gh, n_nodes=1, nbins=4, bits=bits,
                              log2n=2)
    with pytest.raises(TypeError, match="bits"):
        hist.hist_levels_cuda(bins, node, gh, n_nodes=1, nbins=4,
                              bits=bits.long(), log2n=3)
    with pytest.raises(ValueError, match="bits"):
        hist.hist_levels_cuda(bins, node, gh, n_nodes=1, nbins=4,
                              bits=bits.cpu(), log2n=3)


def _distributed_fit_rank(x, y, cfg):
    """One rank of a distributed fit on the card (run by ``run``)."""
    from repro_torch import fit_distributed
    return fit_distributed(x, y, cfg, device="cuda").to("cpu")


@pytest.mark.cuda
@pytest.mark.parametrize("subtract", [False, True])
def test_distributed_fit_is_the_same_at_every_world_size(cuda, subtract):
    """uniform_range on 2 ranks (gloo over CUDA tensors) and on 1 (NCCL):
    every forest field equal (a shared fixed-point grid, int64 sums
    all-reduced); against the single-card fit, structure exact and leaves
    within 1e-4 (tests/test_distributed.py's bound; the base score is
    float32 here, float64 there)."""
    from repro_torch.launch import distributed as dist_lib
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4001, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    cfg = GBDTConfig(n_trees=4, max_depth=4, n_candidates=16,
                     strategy="uniform_range", subtract=subtract)
    one = dist_lib.run(_distributed_fit_rank, 1, x, y, cfg, device="cuda")
    two = dist_lib.run(_distributed_fit_rank, 2, x, y, cfg, device="cuda")
    for field, a, b in zip(one.forest._fields, one.forest, two.forest):
        assert torch.equal(a, b), field
    single = fit(x, y, cfg, device="cuda").forest
    assert torch.equal(single.feature.cpu(), one.forest.feature)
    assert torch.equal(single.split_bin.cpu(), one.forest.split_bin)
    torch.testing.assert_close(single.leaf_value.cpu(),
                               one.forest.leaf_value, rtol=0, atol=1e-4)


def _sharded_serving_rank():
    from repro_torch.launch import serve_gbdt
    model = synthetic_gbdt(n_trees=60, max_depth=5, n_features=8,
                           n_candidates=16, seed=1, device="cuda")
    xb = np.random.default_rng(0).normal(size=(4099, 8)).astype(np.float32)
    return [torch.equal(serve_gbdt.shard_predict(model, xb, binned=b,
                                                 output="margin"),
                        model.predict(xb, binned=b, output="margin"))
            for b in (False, True)]


@pytest.mark.cuda
def test_sharded_serving_on_card_is_bit_identical(cuda):
    from repro_torch.launch import distributed as dist_lib
    assert dist_lib.run(_sharded_serving_rank, 2, device="cuda") == [True,
                                                                     True]


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
@pytest.mark.parametrize("nbins", [1, 2, 9, 16, 17, 33, 65, 256, 257, 300,
                                   1000])
def test_split_gain_kernel_matches_plain_version(cuda, nbins):
    """Bit for bit, empty bins, illegal nodes, NaN gains (l2 = 0,
    min_child_weight = 0) and -inf legal gains (gamma = inf) included;
    with 33 bins also on a panel of the histogram kernel at the timed
    training shape (1M rows x 28 features, 32 nodes)."""
    rng = np.random.default_rng(nbins)
    h = rng.normal(size=(32, 28, nbins, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1])
    h[rng.random(h.shape[:3]) < 0.3] = 0.0
    h[3] = 0.0
    panels = [torch.from_numpy(h).to(cuda)]
    if nbins == 33:
        bins = torch.from_numpy(rng.integers(0, 33, size=(1_000_000, 28))
                                .astype(np.int32)).to(cuda)
        node = torch.from_numpy(rng.integers(0, 32, size=(1, 1_000_000))
                                .astype(np.int32)).to(cuda)
        gh = torch.from_numpy(rng.normal(size=(1_000_000, 2))
                              .astype(np.float32)).to(cuda)
        gh[:, 1].abs_()
        panels.append(hist.hist_levels_cuda(bins, node, gh, n_nodes=32,
                                            nbins=33)[0])
    for (l2, gamma, mcw), hist_t in itertools.product(
            [(1.0, 0.0, 1e-6), (1.0, 0.1, 1.0), (0.0, 0.0, 0.0),
             (0.5, 0.3, 0.5), (1.0, float("inf"), 0.0)], panels):
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
def test_split_gain_kernel_bin_range(cuda):
    """The widest row the kernel takes (its scan in one block's shared
    memory) is bit for bit the plain version; one more bin raises."""
    rng = np.random.default_rng(8)
    top = split_gain.MAX_BINS
    h = rng.normal(size=(2, 3, top, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1])
    hist_t = torch.from_numpy(h).to(cuda)
    g, i = split_gain.split_gain_cuda(hist_t)
    gw, iw = ref.split_gain_ref(hist_t)
    assert torch.equal(g, gw) and torch.equal(i, iw)
    before = split_gain.launches
    with pytest.raises(ValueError, match="bins"):
        split_gain.split_gain_cuda(torch.zeros((1, 1, top + 1, 2),
                                               device=cuda))
    assert split_gain.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("subtract", [False, True])
def test_fit_on_card_matches_cpu(cuda, subtract):
    """A small fit on the card and on the CPU from one injected grid:
    the same trees, through max_depth histogram and max_depth split-gain
    launches a tree.  Structure exact; leaves within 1e-5 of the CPU's
    beyond the CPU's own rounding (``boosting.leaf_rounding``: its
    row-order float32 leaf sums lie up to 1.4e-5 from the exact sums on
    this workload, which the card's fixed-point sums do not share), and
    the card's leaves within 1e-6 of their exact sums."""
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
    diff = (fa.leaf_value.cpu() - fb.leaf_value).abs().double()
    assert bool((diff <= 1e-5 + leaf_rounding(on_cpu, x, y)).all())
    assert float(leaf_rounding(on_card, x, y).max()) <= 1e-6


@pytest.mark.cuda
@pytest.mark.parametrize("subtract", [False, True])
def test_fit_on_card_repeats(cuda, subtract):
    """Two fits from one seed on the card give equal forests, bit for bit:
    the histogram and the leaf sums add in fixed point."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) + 0.5 * rng.normal(size=20_000) > 0)
    cfg = GBDTConfig(n_trees=4, max_depth=6, n_candidates=32,
                     subtract=subtract)
    a, b = (fit(x, y.astype(np.float32), cfg,
                torch.Generator(device="cuda").manual_seed(0),
                device=cuda).forest for _ in range(2))
    for name, fa, fb in zip(a._fields, a, b):
        assert torch.equal(fa, fb), name


def _ties(n, f, seed):
    """Half-integer values (heavy ties), 5 % -0.0 and 5 % +0.0, 2 % NaN of
    either sign; uniform weights with 1 % zeros."""
    rng = np.random.default_rng(seed)
    x = (rng.integers(-6, 7, size=(n, f)) * 0.5).astype(np.float32)
    z = rng.random((n, f))
    x[z < 0.05] = -0.0
    x[(z >= 0.05) & (z < 0.1)] = 0.0
    nan = rng.random((n, f))
    x[nan < 0.01] = np.nan
    x[(nan >= 0.01) & (nan < 0.02)] = -np.float32(np.nan)
    h = rng.random(n).astype(np.float32)
    h[rng.random(n) < 0.01] = 0.0
    return x, h


def _same_grid(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (so in the sign of a zero too), any NaN equal to
    any NaN: IEEE leaves the sign and payload of a NaN that an operation
    returns open, and the card's column minimum returns another NaN than
    the CPU's."""
    a, b = a.cpu(), b.cpu()
    nan = torch.isnan(a)
    return torch.equal(nan, torch.isnan(b)) and torch.equal(
        a.view(torch.int32)[~nan], b.view(torch.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ties", "logistic"])
def test_device_strategies_on_card_equal_cpu(cuda, case):
    """weighted_quantile and uniform_range on the card: the CPU port's
    grids bit for bit, any NaN equal to any NaN (the sort's order of
    -0.0, +0.0 and NaN included; the blocked prefix adds in one order on
    both)."""
    if case == "ties":
        x, h = _ties(50_000, 4, 0)
    else:
        rng = np.random.default_rng(1)
        x = rng.normal(size=(200_000, 6)).astype(np.float32)
        p = 1 / (1 + np.exp(-rng.normal(size=200_000)))
        h = (p * (1 - p)).astype(np.float32)
    xc, hc = torch.from_numpy(x), torch.from_numpy(h)
    xg, hg = xc.to(cuda), hc.to(cuda)
    for k in (8, 32, 255):
        got = proposal.weighted_quantile_candidates(xg, hg, k)
        assert got.device.type == "cuda"
        assert _same_grid(got, proposal.weighted_quantile_candidates(
            xc, hc, k)), k
        got = proposal.uniform_range_candidates(xg, k)
        assert _same_grid(got, proposal.uniform_range_candidates(xc, k)), k
    assert torch.equal(sketch.stable_order(xg.T).cpu(),
                       sketch.stable_order(xc.T))


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["random", "weighted_quantile",
                                      "uniform_range", "gk_quantile",
                                      "exact"])
def test_fit_each_strategy_on_card_matches_cpu(cuda, strategy):
    """A small fit per strategy on the card and on the CPU: the same grids
    (random's injected, the others proposed on each side: mse hessians
    for weighted_quantile, since sigmoid may round apart), through
    max_depth histogram and split-gain launches a tree; structure exact,
    leaves within 1e-5 beyond the CPU's own rounding."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 6)).astype(np.float32)
    y = (x @ rng.normal(size=6) > 0).astype(np.float32)
    cfg = GBDTConfig(n_trees=6, max_depth=4, n_candidates=16,
                     strategy=strategy,
                     objective="mse" if strategy == "weighted_quantile"
                     else "logistic")
    grid = None
    if strategy == "random":
        gen = torch.Generator().manual_seed(0)
        grid = torch.stack([random_candidates(gen, torch.from_numpy(x), 16)
                            for _ in range(6)])
    before = (hist.launches, split_gain.launches)
    on_card = fit(x, y, cfg, candidates=grid, device=cuda)
    assert (hist.launches - before[0],
            split_gain.launches - before[1]) == (6 * 4, 6 * 4)
    on_cpu = fit(x, y, cfg, candidates=grid, device="cpu")
    assert torch.equal(on_card.candidates.cpu(), on_cpu.candidates)
    fa, fb = on_card.forest, on_cpu.forest
    assert torch.equal(fa.feature.cpu(), fb.feature)
    assert torch.equal(fa.split_bin.cpu(), fb.split_bin)
    assert torch.equal(fa.threshold.cpu(), fb.threshold)
    diff = (fa.leaf_value.cpu() - fb.leaf_value).abs().double()
    assert bool((diff <= 1e-5 + leaf_rounding(on_cpu, x, y)).all())
    host = strategy in ("gk_quantile", "exact")
    assert (on_card.proposal_seconds > 0) == host


@pytest.mark.cuda
@pytest.mark.parametrize("strategy", ["random", "weighted_quantile"])
def test_telemetry_and_reference_on_card(cuda, strategy):
    """On the card, a fit with telemetry and ``fit_reference`` give the
    plain fit's forest bit for bit; the report lives on the card."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(20_000, 8)).astype(np.float32)
    y = (x @ rng.normal(size=8) > 0).astype(np.float32)
    cfg = GBDTConfig(n_trees=4, max_depth=6, n_candidates=32,
                     strategy=strategy)

    def gen():
        return torch.Generator(device="cuda").manual_seed(0)
    plain = fit(x, y, cfg, gen(), device=cuda)
    on = fit(x, y, dataclasses.replace(cfg, telemetry=True), gen(),
             device=cuda)
    ref_fit = fit_reference(x, y, cfg, gen(), device=cuda)
    for a, b, c in zip(plain.forest, on.forest, ref_fit.forest):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert plain.report is None and ref_fit.proposal_seconds > 0
    rep = on.report
    assert rep.train_loss.device.type == "cuda" and rep.n_rounds == 4
    assert torch.equal(rep.n_splits.cpu(),
                       (plain.forest.feature >= 0).sum(1).to(torch.int32)
                       .cpu())
    assert bool((rep.hist_updates == 20_000 * 8 * 6).all())
    assert rep.summarize()["train_loss"]["final"] < \
        rep.summarize()["train_loss"]["first"]


def _attn(gen, b, hq, hkv, s, d, dtype, sk=None):
    sk = s if sk is None else sk
    return [torch.randn((b, h, n, d), generator=gen, device="cuda").to(dtype)
            for h, n in ((hq, s), (hkv, sk), (hkv, sk))]


def _attn_close(got, q, k, v, **mask):
    """The kernel's output against the plain version on the same inputs:
    within 2e-4 abs and rel, and in bf16 also one bf16 step of the value
    and the P-rounding bound."""
    want = ref.attention_ref(q, k, v, **mask).float()
    tol = 2e-4 + 2e-4 * want.abs()
    if got.dtype == torch.bfloat16:
        tol += 2.0 ** -7 * want.abs() + ref.attention_rounding_bound(
            q, k, v, **mask)
    diff = (got.float() - want).abs()
    assert bool((diff <= tol).all()), (
        f"max_abs_err {float(diff.max())}, largest excess over the "
        f"tolerance {float((diff - tol).max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_kernel_matches_plain_version(cuda, d, dtype):
    """MHA, GQA, MQA and a group of 16; causal, window 128, 200 (not a
    tile multiple) and 1, none; one and three query tiles of 128, and 2048
    tokens (16 K/V tiles: the Hopper kernel's ring of 3 stages, 4 at
    d = 80, wraps 4 to 5 times); one launch a call, of the kernel the
    dispatch names: bf16 at
    every head dim on the Hopper kernel, float32 on the CUDA-core one."""
    want_variant = ("cuda_core_f32" if dtype == torch.float32 else
                    "wgmma_bf16")
    assert flash.variant(dtype, d) == want_variant
    gen = torch.Generator(device="cuda").manual_seed(d)
    cases = [(b, hq, hkv, s, causal, window)
             for b, hq, hkv in ((2, 4, 4), (1, 8, 2), (1, 4, 1), (1, 16, 1))
             for causal, window in ((True, 0), (True, 128), (True, 200),
                                    (True, 1), (False, 0), (False, 128))
             for s in (128, 384)]
    cases += [(1, 4, 2, 2048, True, 0), (1, 4, 2, 2048, True, 200)]
    for b, hq, hkv, s, causal, window in cases:
        q, k, v = _attn(gen, b, hq, hkv, s, d, dtype)
        before = flash.launches
        before_variant = flash.launches_by_variant[want_variant]
        got = ops.flash_attention(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        assert flash.launches == before + 1
        assert flash.launches_by_variant[want_variant] == before_variant + 1
        assert got.dtype == dtype and got.shape == q.shape
        _attn_close(got, q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("causal,window", [(True, 0), (True, 200),
                                           (False, 0)])
@pytest.mark.parametrize("hkv,d", [(2, 128), (32, 80)],
                         ids=["glm4-9b", "zamba2-2.7b"])
def test_flash_kernel_walks_more_tiles_than_sms(cuda, hkv, d, causal,
                                                window):
    """bf16 at glm4-9b's head geometry (32 query heads on 2 KV heads,
    d = 128) and at zamba2-2.7b's (32:32 heads, d = 80: three column
    chunks of 32, the last half zeros) and 1024 tokens: 512 (head, query
    tile) items, more than an H100 has SMs, so each block of the
    persistent Hopper kernel walks several, reloading Q and running the
    K/V ring on across them."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _attn(gen, 2, 32, hkv, 1024, d, torch.bfloat16)
    assert (2 * 32 * 1024 // 128
            > torch.cuda.get_device_properties(cuda).multi_processor_count)
    before = flash.launches_by_variant["wgmma_bf16"]
    got = flash.flash_attention_cuda(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash.launches_by_variant["wgmma_bf16"] == before + 1
    _attn_close(got, q, k, v, causal=causal, window=window)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s,window", [(1000, 0), (1500, 0), (1000, 200)])
def test_flash_ragged_causal_lengths(cuda, s, window, dtype):
    """``xla_chunked``'s blockwise path at lengths that are not multiples
    of 128 (GQA 8:2, head dim 128): one launch on inputs padded to the
    next multiple, the output sliced back, within the plain version's
    tolerance."""
    gen = torch.Generator(device="cuda").manual_seed(s + window)
    q, k, v = _attn(gen, 1, 8, 2, s, 128, dtype)
    before = flash.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window,
                              ragged=True)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _attn_close(got, q, k, v, causal=True, window=window)


@pytest.mark.cuda
def test_flash_ragged_without_a_mask_raises(cuda):
    """A ragged length with no mask runs on ``xla_chunked``'s blockwise
    path, the padded keys bounded by ``kv_len`` (one launch, within the
    plain version's tolerance on the unpadded inputs); off that path
    (``pallas``) a ragged length raises, as the JAX kernel refuses it.
    The name dates from before the key-length bound, when a ragged
    length with no mask raised; it is kept so that the test's record
    runs on."""
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _attn(gen, 1, 4, 2, 1000, 64, torch.float32)
    before = flash.launches
    got = ops.flash_attention(q, k, v, causal=False, ragged=True)
    torch.cuda.synchronize()
    assert flash.launches == before + 1 and got.shape == q.shape
    _attn_close(got, q, k, v, causal=False)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.flash_attention(q, k, v, causal=True)     # the pallas path
    assert flash.launches == before + 1


KV_LENS = (1, 63, 64, 65, 127, 129, 1500)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_kernel_key_length_bound(cuda, d, dtype):
    """``kv_len`` on K/V padded to a multiple of 128 (the padding random,
    so that a key past the bound that were attended to would show): every
    bound of ``KV_LENS`` (inside a tile, at its edges, past the first
    tile, whisper's 1500 frames in 1536) with 256 queries and no mask; 4
    query tiles against 1536 keys (``sq != sk``); causal over 1536 with
    ``kv_len`` 1500 and with ``kv_len`` = sk, and a window of 200 with
    ``kv_len`` 1000 over 1024 and over 1536 (there the last query tiles'
    bands keep no key, and their rows get 0).  Each within the tolerance of ``ref.attention_ref``
    with the same ``kv_len`` and of ``ref.attention_ref`` on the unpadded
    tensors (on the rows that exist there)."""
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    cases = [(256, -(-n // 128) * 128, n, False, 0) for n in KV_LENS]
    cases += [(512, 1536, 1500, False, 0), (1536, 1536, 1500, True, 0),
              (1536, 1536, 1536, True, 0), (1024, 1024, 1000, True, 200),
              (1536, 1536, 1000, True, 200)]
    for sq, sk, kv_len, causal, window in cases:
        q, k, v = _attn(gen, 1, 4, 2, sq, d, dtype, sk=sk)
        before = flash.launches
        got = flash.flash_attention_cuda(q, k, v, causal=causal,
                                         window=window, kv_len=kv_len)
        torch.cuda.synchronize()
        assert flash.launches == before + 1
        assert got.dtype == dtype and got.shape == q.shape
        mask = dict(causal=causal, window=window)
        _attn_close(got, q, k, v, kv_len=kv_len, **mask)
        rows = sq if sq != sk else kv_len
        _attn_close(got[:, :, :rows].contiguous(), q[:, :, :rows],
                    k[:, :, :kv_len], v[:, :, :kv_len], **mask)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_ragged_cross_attention(cuda, dtype):
    """whisper's cross-attention shape, cut: 1000 queries over 1500 keys,
    MHA at head dim 64, no mask, through ``xla_chunked``'s blockwise path:
    q padded to 1024 by its own length, k/v to 1536 by theirs, one
    launch, the padded keys masked by ``kv_len``."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _attn(gen, 2, 6, 6, 1000, 64, dtype, sk=1500)
    before = flash.launches
    got = ops.flash_attention(q, k, v, causal=False, ragged=True)
    torch.cuda.synchronize()
    assert flash.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    _attn_close(got, q, k, v, causal=False)


@pytest.mark.cuda
def test_flash_kernel_refuses_a_key_length_out_of_range(cuda):
    gen = torch.Generator(device="cuda").manual_seed(6)
    q, k, v = _attn(gen, 1, 4, 2, 128, 64, torch.bfloat16, sk=256)
    before = flash.launches
    for kv_len in (0, 257, -1):
        with pytest.raises(ValueError, match="kv_len"):
            flash.flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    assert flash.launches == before


@pytest.mark.cuda
def test_flash_kernel_unequal_lengths_without_a_mask(cuda):
    """sq = 128 against sk = 384, in float32 and in bf16 (the Hopper
    kernel)."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _attn(gen, 1, 8, 2, 128, 64, dtype, sk=384)
        _attn_close(flash.flash_attention_cuda(q, k, v, causal=False),
                    q, k, v, causal=False)


@pytest.mark.cuda
def test_flash_kernel_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = _attn(gen, 1, 4, 2, 128, 64, torch.float32)
    before = flash.launches
    cases = [
        ((q[0], k, v), {}, ValueError),                       # 3-D q
        ((q.half(), k.half(), v.half()), {}, TypeError),      # float16
        ((q, k.bfloat16(), v.bfloat16()), {}, TypeError),     # mixed dtypes
        ((q.clone().requires_grad_(True), k, v), {},
         ValueError),                                         # no backward
        ((q[:, :, :100].contiguous(), k, v), {}, ValueError),  # sq % 128
        (_attn(gen, 1, 4, 2, 128, 96, torch.float32), {},
         ValueError),                                         # head dim 96
        ((q.transpose(2, 3).contiguous().transpose(2, 3), k, v), {},
         ValueError),                                         # not contiguous
        (_attn(gen, 1, 3, 2, 128, 64, torch.float32), {},
         ValueError),                                         # 3 q : 2 kv
        (_attn(gen, 1, 4, 2, 128, 64, torch.float32, sk=256),
         dict(causal=True), ValueError),                      # sq != sk, mask
        ((q, k, v), dict(window=-1), ValueError),
    ]
    for args, kw, err in cases:
        with pytest.raises(err):
            flash.flash_attention_cuda(*args, **kw)
    assert flash.launches == before
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.flash_attention(q.cpu(), k.cpu(), v.cpu(), backend="cuda")
    with pytest.raises(ValueError, match="runs on CPU tensors"):
        ops.flash_attention(q, k, v, backend="ref")


@pytest.mark.cuda
@pytest.mark.parametrize("attn_impl", ["pallas", "xla_chunked"])
def test_prefill_on_card_matches_cpu(cuda, attn_impl):
    """The SMOKE glm4-9b prefill on the card and on the CPU, same weights:
    logits within 3e-2 abs and rel (bf16 products summed in other orders;
    the JAX package's bf16 attention tolerance); ``pallas`` launches the
    kernel once a layer, ``xla_chunked`` at 128 tokens takes the naive
    path and none.  The SMOKE head dim (32) in bf16 runs on the Hopper
    kernel."""
    cfg = dataclasses.replace(get_config("glm4-9b", smoke=True),
                              attn_impl=attn_impl)
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device=cuda)
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (2, 128))
    step = make_prefill_step(cfg)
    before = flash.launches
    before_wgmma = flash.launches_by_variant["wgmma_bf16"]
    card = step(model, {"tokens": tokens}).float().cpu()
    want = cfg.n_layers if attn_impl == "pallas" else 0
    assert flash.launches - before == want
    assert flash.launches_by_variant["wgmma_bf16"] - before_wgmma == want
    on_cpu = step(model.to("cpu"), {"tokens": tokens}).float()
    torch.testing.assert_close(card, on_cpu, rtol=3e-2, atol=3e-2)


# --------------------------------------------------------------------------
# decode and the moe family
# --------------------------------------------------------------------------

def _card_and_cpu(cfg, seed=0):
    """The same model on the card (bf16 storage) and on the CPU (float32
    storage: the bf16 weights widened exactly)."""
    card = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(seed), device="cuda")
    host = init_params(cfg, device="meta", dtype=torch.float32)
    host.load_state_dict({k: v.to("cpu", torch.float32) for k, v in
                          card.state_dict().items()}, assign=True)
    return card, host


def _float32_decode(model, cfg, state, tokens, pos, *, window=0):
    """A decode step with float32 activations: the embedding widened, then
    each block's decode over ``state`` (updated in place), ``ln_f`` and
    the logits, as ``decode_step`` runs them in bf16."""
    with torch.inference_mode():
        device = model.embed.table.device
        x = model.embed(torch.as_tensor(tokens, device=device),
                        dtype=torch.float32)
        x = model.decode_backbone(cfg, x, state,
                                  torch.as_tensor(pos, device=device),
                                  window=window)
        return model.logits(model.ln_f(x))


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["glm4-9b", "deepseek-moe-16b"])
@pytest.mark.parametrize("window,steps,cache_len", [(0, 16, 19), (8, 20, 8)],
                         ids=["window0", "ring-wrap"])
def test_decode_on_card_matches_cpu(cuda, name, window, steps, cache_len):
    """SMOKE decode, teacher-forced, rows at different positions, float32
    activations and caches: every step's logits within 2e-4 abs and rel of
    the CPU's, the caches too, the same slots written (under window 8 over
    20 tokens the ring buffer wraps twice); no kernel of the port runs."""
    cfg = get_config(name, smoke=True)
    card, host = _card_and_cpu(cfg)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, steps)))
    offsets = torch.tensor([0, 3])
    states = {dev: init_decode_state(cfg, 2, cache_len, device=dev,
                                     dtype=torch.float32)
              for dev in ("cuda", "cpu")}
    before = flash.launches
    for t in range(steps):
        out = {}
        for dev, m in (("cuda", card), ("cpu", host)):
            out[dev] = _float32_decode(m, cfg, states[dev],
                                       tokens[:, t:t + 1], t + offsets,
                                       window=window)
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"],
                                   rtol=2e-4, atol=2e-4)
    assert flash.launches == before
    for key in ("k", "v"):
        got, want = states["cuda"]["kv"][key].cpu(), states["cpu"]["kv"][key]
        assert torch.equal(got != 0, want != 0)
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_generate_on_card(cuda):
    """``serve.generate`` at SMOKE size on the card: bf16 greedy decode,
    the first token the argmax of the last prompt position, no flash
    launch; the prompts are the CPU generator's, as on the CPU."""
    before = flash.launches
    run = serve.generate("glm4-9b", smoke=True, batch=2, prompt_len=8,
                         gen=4)
    assert flash.launches == before
    assert run.tokens.device.type == "cuda" and run.tokens.shape == (2, 4)
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))
    on_cpu = serve.generate("glm4-9b", smoke=True, batch=2, prompt_len=8,
                            gen=4, device="cpu")
    assert torch.equal(run.prompts.cpu(), on_cpu.prompts)


@pytest.mark.cuda
@pytest.mark.parametrize("capacity_factor", [8.0, 1.25, 0.5])
def test_moe_layer_on_card_matches_cpu(cuda, capacity_factor):
    """The SMOKE MoE layer on the card and on the CPU, float32: outputs
    within 2e-4 abs and rel, aux within 1e-6, the same dropped count (none
    at 8.0; half the assignments at 0.5)."""
    cfg = dataclasses.replace(get_config("deepseek-moe-16b", smoke=True),
                              capacity_factor=capacity_factor)
    card_m = moe.MoE(cfg, generator=torch.Generator(device="cuda").manual_seed(
        2), device="cuda", dtype=torch.float32)
    host_m = moe.MoE(cfg, device="meta", dtype=torch.float32)
    host_m.load_state_dict({k: v.cpu() for k, v in card_m.state_dict()
                            .items()}, assign=True)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(3))
    y_card, aux_card = moe.moe_layer(card_m, cfg, x.cuda())
    y_cpu, aux_cpu = moe.moe_layer(host_m, cfg, x)
    torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
    torch.testing.assert_close(aux_card.cpu(), aux_cpu, rtol=1e-6, atol=0)
    dropped = int(card_m.n_dropped)
    assert dropped == int(host_m.n_dropped)
    if capacity_factor == 8.0:
        assert dropped == 0
    if capacity_factor == 0.5:
        assert dropped >= 64          # 4 experts x 16 slots for 128


@pytest.mark.cuda
def test_moe_sort_equals_onehot_on_card(cuda):
    """With room for every assignment, ``sort`` and ``onehot`` dispatch
    give the same bf16 prefill logits on the card, bit for bit."""
    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b", smoke=True),
                              capacity_factor=8.0)
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(0), device=cuda)
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 128))
    out = {d: make_prefill_step(dataclasses.replace(cfg, moe_dispatch=d))(
        model, {"tokens": tokens}) for d in ("onehot", "sort")}
    assert torch.equal(out["onehot"], out["sort"])
    assert bool(torch.isfinite(out["sort"]).all())


# --------------------------------------------------------------------------
# the ssm and hybrid families
# --------------------------------------------------------------------------

SSM_BLOCKS = {"mamba2": ("zamba2-2.7b", ssm.Mamba2, ssm.mamba2_step),
              "mlstm": ("xlstm-125m", ssm.MLSTM, ssm.mlstm_step),
              "slstm": ("xlstm-125m", ssm.SLSTM, ssm.slstm_step)}


def _on_cpu(state):
    if isinstance(state, tuple):
        return tuple(t.cpu() for t in state)
    return state.cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("block", list(SSM_BLOCKS))
def test_ssm_block_on_card_matches_cpu(cuda, block):
    """A SMOKE block in float32 on the card and on the CPU, same weights:
    the layer over 64 tokens (two chunks), then 8 decode steps from its
    state; outputs and states within 2e-4 abs and rel."""
    arch, cls, step = SSM_BLOCKS[block]
    cfg = get_config(arch, smoke=True)
    card_m = cls(cfg, generator=torch.Generator(device="cuda").manual_seed(
        5), device="cuda", dtype=torch.float32)
    host_m = cls(cfg, device="meta", dtype=torch.float32)
    host_m.load_state_dict({k: v.cpu() for k, v in card_m.state_dict()
                            .items()}, assign=True)
    x = torch.randn((2, 72, cfg.d_model),
                    generator=torch.Generator().manual_seed(6)) * 0.5
    with torch.inference_mode():
        y_card, st_card = card_m(cfg, x[:, :64].cuda())
        y_cpu, st_cpu = host_m(cfg, x[:, :64])
        torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=2e-4, atol=2e-4)
        for t in range(64, 72):
            y_card, st_card = step(card_m, cfg, x[:, t:t + 1].cuda(), st_card)
            y_cpu, st_cpu = step(host_m, cfg, x[:, t:t + 1], st_cpu)
            torch.testing.assert_close(y_card.cpu(), y_cpu, rtol=2e-4,
                                       atol=2e-4)
    torch.testing.assert_close(_on_cpu(st_card), st_cpu, rtol=2e-4,
                               atol=2e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_ssm_decode_on_card_matches_cpu(cuda, name):
    """SMOKE with two groups, teacher-forced, rows at different positions,
    float32 activations and caches: every step's logits within 2e-4 abs
    and rel of the CPU's, and the recurrent states and zamba2's per-group
    KV caches too, the same slots written; no kernel of the port runs."""
    cfg = dataclasses.replace(get_config(name, smoke=True), n_layers=4)
    card, host = _card_and_cpu(cfg)
    tokens = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (2, 20)))
    offsets = torch.tensor([0, 3])
    states = {dev: init_decode_state(cfg, 2, 24, device=dev,
                                     dtype=torch.float32)
              for dev in ("cuda", "cpu")}
    before = flash.launches
    for t in range(20):
        out = {dev: _float32_decode(m, cfg, states[dev], tokens[:, t:t + 1],
                                    t + offsets)
               for dev, m in (("cuda", card), ("cpu", host))}
        torch.testing.assert_close(out["cuda"].cpu(), out["cpu"],
                                   rtol=2e-4, atol=2e-4)
    assert flash.launches == before
    want = flat_state(states["cpu"])
    for key, got in flat_state(states["cuda"]).items():
        got = got.cpu()
        assert torch.equal(got != 0, want[key] != 0), key
        torch.testing.assert_close(got, want[key], rtol=2e-4, atol=2e-4)


def _float32_prefill(model, cfg, tokens):
    with torch.inference_mode():
        t = torch.as_tensor(tokens, device=model.embed.table.device)
        x = model.embed(t, dtype=torch.float32)
        x, _ = model.backbone(cfg, x, torch.arange(
            t.shape[1], device=x.device).expand(*t.shape))
        return model.logits(model.ln_f(x)).float().cpu()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-2.7b"])
def test_ssm_prefill_on_card_matches_cpu(cuda, name):
    """The SMOKE prefill (two groups, ``pallas``: zamba2's shared block
    launches the flash kernel once a group, on the Hopper kernel at head
    dim 32): the bf16 step finite on the card; with float32 activations
    the card within 2e-4 abs and rel of the CPU.  (bf16 roundings an ulp
    apart grow through zamba2's Mamba2 layers past 3e-2 in places, so the
    bf16 logits are held at full width, in ``chip_smoke.py``, against the
    float32 ones.)"""
    cfg = dataclasses.replace(get_config(name, smoke=True), n_layers=4,
                              attn_impl="pallas")
    model = init_params(cfg, generator=torch.Generator(
        device="cuda").manual_seed(8), device=cuda)
    tokens = np.random.default_rng(8).integers(0, cfg.vocab_size, (2, 128))
    before = flash.launches_by_variant["wgmma_bf16"]
    card = make_prefill_step(cfg)(model, {"tokens": tokens})
    groups = 2 if cfg.family == "hybrid" else 0
    assert flash.launches_by_variant["wgmma_bf16"] - before == groups
    assert bool(torch.isfinite(card).all())
    card_f32 = _float32_prefill(model, cfg, tokens)
    f32 = _float32_prefill(model.to("cpu"), cfg, tokens)
    torch.testing.assert_close(card_f32, f32, rtol=2e-4, atol=2e-4)


@pytest.mark.cuda
def test_generate_zamba2_on_card(cuda):
    before = flash.launches
    run = serve.generate("zamba2-2.7b", smoke=True, batch=2, prompt_len=8,
                         gen=4)
    assert flash.launches == before
    assert run.tokens.device.type == "cuda" and run.tokens.shape == (2, 4)
    assert torch.equal(run.tokens[:, 0], run.last_logits[:, -1].argmax(-1))


# --------------------------------------------------------------------------
# LM training: the attention backward kernel and the train step
# --------------------------------------------------------------------------

BWD_MASKS = {"causal": dict(causal=True, window=0, kv_len=None),
             "window": dict(causal=True, window=100, kv_len=None),
             "ragged": dict(causal=False, window=0, kv_len=300),
             "none": dict(causal=False, window=0, kv_len=None)}


def _bwd_close(got, want, bound, dtype):
    """The backward kernel against ``ref.attention_bwd_ref``: float32
    within 2e-4 of the largest (and at least 1), bf16 within that plus one
    bf16 step of the value plus ``ref.attention_bwd_rounding_bound`` (P
    and dS rounded to bf16 as operands)."""
    for name, g, w, bd in zip(("dq", "dk", "dv"), got, want, bound):
        assert g.dtype == dtype and g.shape == w.shape, name
        w = w.float()
        tol = 2e-4 * max(1.0, float(w.abs().max()))
        if dtype == torch.bfloat16:
            tol = tol + 2.0 ** -7 * w.abs() + bd
        diff = (g.float() - w).abs()
        assert bool((diff <= tol).all()), (
            f"{name}: max_abs_err {float(diff.max())}, largest excess "
            f"{float((diff - tol).max())}")


@pytest.mark.cuda
@pytest.mark.parametrize("mask", list(BWD_MASKS))
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_bwd_kernel_matches_plain_version(cuda, d, mask):
    """GQA 16:2 and MHA, float32 and bf16; sq 256 against sk 384 where
    there is no mask (key-length bound 300 in ``ragged``); one launch a
    call of each kernel of the call's variant that it runs
    (``flash.bwd_kernels``: ``bwd_dq``, ``bwd_dkdv`` in float32;
    ``bwd_dq_wgmma``, ``bwd_dkdv_wgmma`` and, where the group is split,
    ``bwd_dkdv_sum`` in bf16) and the same bits on a second call."""
    gen = torch.Generator(device="cuda").manual_seed(d)
    kw = BWD_MASKS[mask]
    sk = 256 if kw["causal"] else 384
    for dtype in (torch.float32, torch.bfloat16):
        for hq, hkv in ((16, 2), (4, 4)):
            q, k, v = _attn(gen, 1, hq, hkv, 256, d, dtype, sk=sk)
            o = ref.attention_ref(q, k, v, **kw)
            do = torch.randn(o.shape, generator=gen, device="cuda").to(dtype)
            before = dict(flash.bwd_launches_by_kernel)
            got = flash.flash_attention_bwd_cuda(q, k, v, o, do, **kw)
            ran = flash.bwd_kernels(dtype, 1, hq, hkv, sk,
                                    flash.sm_count(q.device))
            assert all(flash.bwd_launches_by_kernel[n]
                       == before[n] + (n in ran) for n in before)
            _bwd_close(got, ref.attention_bwd_ref(q, k, v, o, do, **kw),
                       ref.attention_bwd_rounding_bound(q, k, v, o, do, **kw),
                       dtype)
            again = flash.flash_attention_bwd_cuda(q, k, v, o, do, **kw)
            assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.cuda
def test_flash_bwd_kernel_takes_the_callers_lse(cuda):
    """Given the rows' log-sum-exp, the first kernel skips its own pass:
    the same gradients within the bf16 contract."""
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = _attn(gen, 1, 4, 2, 256, 64, torch.bfloat16)
    o = flash.flash_attention_cuda(q, k, v, causal=True)
    do = torch.randn(o.shape, generator=gen, device="cuda").bfloat16()
    s = (q.float().reshape(1, 2, 512, 64) @ k.float().transpose(-1, -2)) / 8
    keep = torch.ones(256, 256, dtype=torch.bool, device="cuda").tril()
    lse = torch.logsumexp(s.masked_fill(~keep.repeat(2, 1), float("-inf")),
                          -1).reshape(1, 4, 256)
    got = flash.flash_attention_bwd_cuda(q, k, v, o, do, causal=True,
                                         lse=lse)
    _bwd_close(got, ref.attention_bwd_ref(q, k, v, o, do, causal=True),
               ref.attention_bwd_rounding_bound(q, k, v, o, do, causal=True),
               torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [32, 64, 80, 128])
def test_flash_forward_lse_matches_plain_version(cuda, d):
    """The bf16 forward's lse (``with_lse``) against ``ref.attention_lse``
    within 2e-4 of max(1, |lse|), the rows that keep no key +inf in both;
    the output the same bits as without it."""
    gen = torch.Generator(device="cuda").manual_seed(d + 1)
    q, k, v = _attn(gen, 1, 4, 2, 384, d, torch.bfloat16)
    for kw in (dict(causal=True, window=50, kv_len=200),
               dict(causal=False, window=0, kv_len=300)):
        out, lse = flash.flash_attention_cuda(q, k, v, with_lse=True, **kw)
        assert torch.equal(out, flash.flash_attention_cuda(q, k, v, **kw))
        want = ref.attention_lse(q, k, **kw)
        assert torch.equal(torch.isinf(lse), torch.isinf(want))
        fin = ~torch.isinf(want)
        tol = 2e-4 * want[fin].abs().clamp(min=1.0)
        assert bool(((lse[fin] - want[fin]).abs() <= tol).all())
    with pytest.raises(ValueError):
        flash.flash_attention_cuda(q.float(), k.float(), v.float(),
                                   with_lse=True)


@pytest.mark.cuda
def test_flash_bwd_kernel_rejects_what_it_does_not_take(cuda):
    gen = torch.Generator(device="cuda").manual_seed(4)
    q, k, v = _attn(gen, 1, 4, 2, 128, 64, torch.bfloat16)
    o = flash.flash_attention_cuda(q, k, v)
    before = flash.bwd_launches
    for args, kw in [((q, k, v, o[:, :2].contiguous(), o), {}),   # o shape
                     ((q, k, v, o, o.float()), {}),               # do dtype
                     ((q, k, v, o.clone().requires_grad_(True), o), {}),
                     ((q, k, v, o, o),
                      dict(lse=torch.zeros(1, 4, 64, device="cuda")))]:
        with pytest.raises(ValueError):
            flash.flash_attention_bwd_cuda(*args, **kw)
    assert flash.bwd_launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_flash_attention_under_autograd_on_card(cuda, dtype):
    """``ops.flash_attention`` with ``ragged`` at 1000 tokens: padded to
    1024 outside the autograd function, one forward and one backward call
    of the kernels, the gradients of the unpadded inputs against the
    plain backward on the CPU given the same inputs and the kernel's own
    output (``delta = rowsum(do * o)`` reads it)."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = _attn(gen, 1, 8, 2, 1000, 64, dtype)
    do = torch.randn(q.shape, generator=gen, device="cuda").to(dtype)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    f0, b0 = flash.launches, flash.bwd_launches
    out = ops.flash_attention(*leaves, causal=True, ragged=True)
    out.backward(do)
    assert (flash.launches - f0, flash.bwd_launches - b0) == (1, 1)
    cpu = [t.detach().cpu().float() for t in (q, k, v)]
    o = out.detach().cpu().float()
    want = ref.attention_bwd_ref(*cpu, o, do.cpu().float(), causal=True)
    bound = ref.attention_bwd_rounding_bound(*cpu, o, do.cpu().float(),
                                             causal=True)
    _bwd_close([t.grad.cpu() for t in leaves], [w.to(dtype) for w in want],
               bound, dtype)


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """One SMOKE internvl2-1b train step (2 layers, 16 patches + 240
    tokens, ``pallas``: the flash kernels forward and backward) on the card
    and on the CPU from the same float32 weights, float32 activations: the
    loss and gnorm within 2e-4 relative, the moments within 2e-4 of each
    leaf's largest, the parameters within 2 lr (a gradient near 0 may
    take Adam's first step the other way) plus 2e-6."""
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.optim import AdamWConfig
    cfg = dataclasses.replace(get_config("internvl2-1b", smoke=True),
                              attn_impl="pallas")
    opt = AdamWConfig(lr=1e-3, warmup_steps=0, total_steps=10)
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 240)),
             "patches": torch.from_numpy(rng.normal(size=(
                 2, cfg.n_frontend_tokens, cfg.d_model)).astype(np.float32))}
    out = {}
    for device in ("cuda", "cpu"):
        model, state = init_train_state(
            cfg, torch.Generator().manual_seed(0), opt, device="cpu")
        model.to(device)
        state = {"m": {n: t.to(device) for n, t in state["m"].items()},
                 "v": {n: t.to(device) for n, t in state["v"].items()},
                 "step": state["step"].to(device)}
        f0, b0 = flash.launches, flash.bwd_launches
        model, state, metrics = make_train_step(cfg, opt,
                                                dtype=torch.float32)(
            model, state, batch)
        launches = (flash.launches - f0, flash.bwd_launches - b0)
        out[device] = (model, state, metrics, launches)
    # remat: the forward runs again in the backward, a launch a layer each
    assert out["cuda"][3] == (2 * cfg.n_layers, cfg.n_layers)
    assert out["cpu"][3] == (0, 0)
    for key in ("loss", "gnorm"):
        assert float(out["cuda"][2][key]) == pytest.approx(
            float(out["cpu"][2][key]), rel=2e-4)
    for (name, p), (_, want) in zip(out["cuda"][0].named_parameters(),
                                    out["cpu"][0].named_parameters()):
        diff = (p.detach().cpu() - want.detach()).abs().max()
        assert float(diff) <= 2 * opt.lr + 2e-6, name
        for part in ("m", "v"):
            got, w = out["cuda"][1][part][name].cpu(), out["cpu"][1][part][
                name]
            assert float((got - w).abs().max()) <= 2e-4 * float(
                w.abs().max()) + 1e-12, (part, name)
