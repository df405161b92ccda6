"""Parity of the port's split gain with the JAX package's.

Contract: the plain ``split_gain_ref`` equals the JAX ``split_gain_ref``
bit for bit on the CPU (gains and bins), including empty bins, nodes
where no split is legal and NaN gains (``l2 = 0`` with
``min_child_weight = 0``).  That needs the prefix sums in XLA:CPU's own
association, which ``ref.blocked_prefix`` writes out: a blocked scan of
16, recursively; ``torch.cumsum`` adds in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro_torch.kernels import ops, ref, split_gain

PARAMS = [(1.0, 0.0, 1e-6), (1.0, 0.0, 1.0), (0.5, 0.1, 1.0),
          (1.0, 0.3, 0.5), (2.0, 1.0, 5.0)]


def _hist(rng, n_nodes, f, nbins):
    """A histogram with empty bins (30 %), an all-empty node, and a node
    whose hessian is too small to split anywhere."""
    h = rng.normal(size=(n_nodes, f, nbins, 2)).astype(np.float32)
    h[..., 1] = np.abs(h[..., 1])
    h[rng.random(h.shape[:3]) < 0.3] = 0.0
    h[0] = 0.0
    h[1, ..., 1] *= 1e-3
    return h


def _both(h, **kw):
    jg, ji = jref.split_gain_ref(jnp.asarray(h), **kw)
    tg, ti = ref.split_gain_ref(torch.from_numpy(h), **kw)
    assert tg.dtype == torch.float32 and ti.dtype == torch.int32
    return (tg.numpy(), ti.numpy()), (np.asarray(jg), np.asarray(ji))


@pytest.mark.parametrize("nbins", [2, 9, 17, 33, 65, 257])
@pytest.mark.parametrize("l2,gamma,min_child_weight", PARAMS)
def test_split_gain_ref_bit_equal(nbins, l2, gamma, min_child_weight):
    h = _hist(np.random.default_rng(nbins), 6, 5, nbins)
    (tg, ti), (jg, ji) = _both(h, l2=l2, gamma=gamma,
                               min_child_weight=min_child_weight)
    assert np.array_equal(tg, jg)
    assert np.array_equal(ti, ji)
    assert np.isneginf(tg[0]).all() and (ti[0] == 0).all()   # empty node


@pytest.mark.parametrize("nbins", [9, 33])
def test_split_gain_nan_gains_bit_equal(nbins):
    """With l2 = 0 and min_child_weight = 0, empty sides give 0/0 = NaN:
    NaN is the maximum and the first NaN wins, as in jnp.argmax."""
    h = _hist(np.random.default_rng(1), 4, 3, nbins)
    (tg, ti), (jg, ji) = _both(h, l2=0.0, gamma=0.0, min_child_weight=0.0)
    assert np.isnan(jg).any()
    assert np.array_equal(tg, jg, equal_nan=True)
    assert np.array_equal(ti, ji)


@pytest.mark.parametrize("n", [1, 2, 9, 16, 17, 33, 256, 257, 300, 5000])
def test_blocked_prefix_is_xla_cumsum(n):
    """Above 272 elements the block totals are themselves scanned in
    blocks of 16; the recursion covers that."""
    rng = np.random.default_rng(n)
    x = rng.normal(size=(3, 2, n)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    want = np.asarray(jax.jit(lambda a: jnp.cumsum(a, axis=2))(x))
    assert np.array_equal(ref.blocked_prefix(torch.from_numpy(x)).numpy(),
                          want)


def test_argmax_nan_first_matches_jnp():
    x = np.array([[1.0, 3.0, 3.0, -np.inf],
                  [np.nan, 2.0, np.nan, 5.0],
                  [-np.inf, -np.inf, -np.inf, -np.inf],
                  [0.0, np.nan, 7.0, 7.0]], np.float32)
    best, idx = ref.argmax_nan_first(torch.from_numpy(x), dim=1)
    assert np.array_equal(best.numpy(), np.asarray(jnp.max(x, axis=1)),
                          equal_nan=True)
    assert np.array_equal(idx.numpy(), np.asarray(jnp.argmax(x, axis=1)))


def test_ops_split_gain_dispatch():
    h = torch.from_numpy(_hist(np.random.default_rng(3), 4, 3, 9))
    g, i = ops.split_gain(h, l2=1.0, gamma=0.0, min_child_weight=1.0)
    gw, iw = ref.split_gain_ref(h, l2=1.0, gamma=0.0, min_child_weight=1.0)
    assert torch.equal(g, gw) and torch.equal(i, iw)
    g, i = ops.split_gain(h, min_child_weight=1.0, backend="interpret")
    assert torch.equal(g, gw) and torch.equal(i, iw)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        ops.split_gain(h, backend="cuda")


def test_kernel_wrapper_takes_no_cpu_tensor():
    h = torch.from_numpy(_hist(np.random.default_rng(0), 2, 2, 5))
    before = split_gain.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        split_gain.split_gain_cuda(h)
    assert split_gain.launches == before
