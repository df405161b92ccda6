"""Parity of the port's split gain with the JAX package's.

Contract: the plain ``split_gain_ref`` equals the JAX ``split_gain_ref``
bit for bit on the CPU (gains and bins), including empty bins, nodes
where no split is legal and NaN gains (``l2 = 0`` with
``min_child_weight = 0``).  That needs the prefix sums in XLA:CPU's own
association, which ``ref.blocked_prefix`` writes out: a blocked scan of
16, recursively; ``torch.cumsum`` adds in another order.

The card kernel spreads the work across bins without changing that
association; its decomposition is emulated here in plain torch and held
to the same bits (the kernel itself is held on the card by
tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.kernels import ref as jref
from repro.kernels.split_gain import split_gain_pallas
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


# -- the card kernel's decomposition, in plain torch -------------------------

def _kernel_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix along the last axis as ``csrc/split_gain.cu``
    builds it: bottom up, every entry of a level is the sequential sum of
    its block of 16 up to it, recomputed on its own; a level of more than
    16 entries is followed by one of its block totals (the local prefix
    at each block's last entry); top down, from the second block on an
    entry adds the prefix one level up at the previous block."""
    levels = [x]
    locals_ = []
    while True:
        inp = levels[-1]
        m = inp.shape[-1]
        local = torch.empty_like(inp)
        for i in range(m):
            b0 = i - i % ref.PREFIX_BLOCK
            v = inp[..., b0].clone()
            for k in range(b0 + 1, i + 1):
                v = v + inp[..., k]
            local[..., i] = v
        locals_.append(local)
        if m <= ref.PREFIX_BLOCK:
            break
        last = [min(k * ref.PREFIX_BLOCK + ref.PREFIX_BLOCK - 1, m - 1)
                for k in range(-(-m // ref.PREFIX_BLOCK))]
        levels.append(local[..., last])
    prefix = locals_[-1]
    for local in reversed(locals_[:-1]):
        out = local.clone()
        for i in range(ref.PREFIX_BLOCK, local.shape[-1]):
            out[..., i] = prefix[..., i // ref.PREFIX_BLOCK - 1] + local[..., i]
        prefix = out
    return prefix


def _order_free_argmax(gain: torch.Tensor, rng) -> tuple:
    """The kernel's (gain, bin) reduction, pairwise in a shuffled order:
    a NaN beats everything, then the larger gain, then the smaller bin."""
    g = gain.reshape(-1, gain.shape[-1])
    perm = torch.from_numpy(rng.permutation(g.shape[-1]))
    g, s = g[:, perm], perm.expand(g.shape[0], -1).clone()
    while g.shape[-1] > 1:
        if g.shape[-1] % 2:
            g = torch.cat([g, g.new_full((g.shape[0], 1), float("-inf"))], 1)
            s = torch.cat([s, s.new_full((s.shape[0], 1), 2 ** 31 - 1)], 1)
        a, b, sa, sb = g[:, 0::2], g[:, 1::2], s[:, 0::2], s[:, 1::2]
        na, nb = torch.isnan(a), torch.isnan(b)
        take_a = torch.where(na | nb, na & (~nb | (sa < sb)),
                             (a > b) | ((a == b) & (sa < sb)))
        g, s = torch.where(take_a, a, b), torch.where(take_a, sa, sb)
    return (g[:, 0].reshape(gain.shape[:-1]),
            s[:, 0].to(torch.int32).reshape(gain.shape[:-1]))


def _kernel_emulation(hist, *, l2, gamma, min_child_weight, rng):
    g, h = hist[..., 0], hist[..., 1]
    gl, hl = _kernel_prefix(g), _kernel_prefix(h)
    gt, ht = gl[..., -1:], hl[..., -1:]
    gain = 0.5 * (ref._score(gl, hl, l2) + ref._score(gt - gl, ht - hl, l2)
                  - ref._score(gt, ht, l2)) - gamma
    nbins = gain.shape[-1]
    ok = (hl >= min_child_weight) & (ht - hl >= min_child_weight) \
        & (torch.arange(nbins) < nbins - 1)
    return _order_free_argmax(torch.where(ok, gain, float("-inf")), rng)


CASES = {  # name: (l2, gamma, min_child_weight)
    "plain": (1.0, 0.0, 1e-6),
    "nan_gains": (0.0, 0.0, 0.0),
    "all_illegal": (1.0, 0.0, 1e9),
    "neg_inf_legal": (1.0, float("inf"), 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("nbins", [1, 2, 9, 16, 17, 33, 256, 257, 300])
def test_kernel_decomposition_bit_equal(nbins, case):
    """The card kernel's association (per-bin recomputed blocked prefix,
    then the order-free (gain, bin) reduction in a shuffled order) equals
    the plain version and the JAX Pallas kernel (interpret mode) bit for
    bit; rows of equal gains (runs of empty bins) are ties, which the
    smaller bin wins."""
    l2, gamma, mcw = CASES[case]
    rng = np.random.default_rng(1000 + nbins)
    h = _hist(rng, 4, 3, nbins)
    h[2, 0, : nbins // 2] = 0.0          # a run of equal prefixes: ties
    th = torch.from_numpy(h)
    eg, ei = _kernel_emulation(th, l2=l2, gamma=gamma, min_child_weight=mcw,
                               rng=rng)
    rg, ri = ref.split_gain_ref(th, l2=l2, gamma=gamma, min_child_weight=mcw)
    pg, pi = split_gain_pallas(jnp.asarray(h), l2=l2, gamma=gamma,
                               min_child_weight=mcw, interpret=True)
    for gains, idx in ((rg.numpy(), ri.numpy()),
                       (np.asarray(pg), np.asarray(pi))):
        assert np.array_equal(eg.numpy(), gains, equal_nan=True)
        assert np.array_equal(ei.numpy(), idx)
    if case in ("all_illegal", "neg_inf_legal"):
        assert np.isneginf(eg.numpy()).all() and (ei.numpy() == 0).all()
    if case == "nan_gains" and nbins > 2:
        assert np.isnan(eg.numpy()).any()
