"""The port's CUDA kernels on the card (``cuda``-marked; skip without a GPU).

This file imports nothing of JAX, so it also runs on a machine that has
a GPU and no JAX:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version with
``torch.equal``: traversal is pure selects and the ensemble sum is the
same float32 adds in the same order, so nothing may differ by a bit.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref, traverse
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
