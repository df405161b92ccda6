"""The attention backward's plain version and autograd path, on the CPU.

``ref.attention_bwd_ref`` is what the card's backward kernel
(``csrc/flash_attention_bwd.cu``) is held against.  Here it is held
against two independent gradients of the same function, in float32:

* autograd through ``ref.attention_ref``, within 2e-5 of the largest
  gradient (the two sum the same float32 products in other orders: the
  explicit form uses ``delta = rowsum(do * o)`` where autograd sums ``p *
  dp``);
* ``jax.grad`` of the JAX package's ``_flash_xla`` (the blockwise path
  that the JAX package trains through, its backward rematerialised by
  ``jax.checkpoint``), within the same 2e-5: another order again, and
  XLA's exp.

``ops.flash_attention`` under autograd goes through ``ops.
FlashAttention``, whose CPU backward is ``attention_bwd_ref``: its
gradients equal it bit for bit, and without grad mode the call is the
plain ``attention_ref`` as before.  On the card the bf16 forward hands the
backward its rows' log-sum-exp: ``ref.attention_lse`` is its plain
version, and ``attention_bwd_ref`` given it is bit for bit the same as
without it, and as close to ``jax.grad``.  The host's choice of the bf16
backward's dK/dV work items (``flash_attention.dkdv_heads_per_chunk``) is
checked at the training shapes.  ``ref.attention_bwd_rounding_bound``
is checked to cover an emulation of the bf16 kernel's roundings (P and
dS rounded to bf16 as operands) in plain torch.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.models.attention import _flash_xla
from repro_torch.kernels import flash_attention as flash, ops, ref

TOL = 2e-5

# (batch, q heads, kv heads, sq, sk, causal, window, kv_len)
CASES = [(1, 4, 4, 32, 32, True, 0, None),      # MHA, causal
         (2, 6, 2, 48, 48, True, 0, None),      # GQA 3:1
         (1, 8, 1, 40, 40, True, 9, None),      # MQA, sliding window
         (1, 4, 2, 24, 56, False, 0, None),     # no mask, sq != sk
         (1, 4, 2, 24, 56, False, 0, 37),       # and a key-length bound
         (1, 2, 2, 32, 32, False, 5, None),     # window without causal
         (1, 4, 2, 32, 32, True, 4, 3)]         # rows that keep no key
IDS = ["mha-causal", "gqa-causal", "mqa-window", "no-mask", "kv-len",
       "window-only", "empty-rows"]


def _inputs(case, d=16, seed=0):
    b, hq, hkv, sq, sk = case[:5]
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    do = rng.normal(size=(b, hq, sq, d)).astype(np.float32)
    mask = dict(causal=case[5], window=case[6], kv_len=case[7])
    return q, k, v, do, mask


def _close(got, want, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL * scale,
                               err_msg=name)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_matches_autograd_of_attention_ref(case):
    q, k, v, do, mask = _inputs(case)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.attention_ref(qt, kt, vt, **mask)
    grads = torch.autograd.grad(out, (qt, kt, vt), torch.from_numpy(do))
    want = ref.attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 out.detach(), torch.from_numpy(do), **mask)
    for name, g, w in zip("qkv", grads, want):
        assert w.dtype == torch.float32 and w.shape == g.shape
        _close(w, g, "d" + name)
    if case[7] == 3:        # the rows past the window of 3 kept keys
        assert not want[0][:, :, 7:].any()


@pytest.mark.parametrize("case", [c for c in CASES if c[7] is None],
                         ids=[i for c, i in zip(CASES, IDS) if c[7] is None])
def test_bwd_ref_matches_jax_grad_of_flash_xla(case):
    """The JAX package's blockwise attention counts query positions from
    0, as the kernel does, so a mask needs sq == sk (both packages refuse
    it otherwise)."""
    q, k, v, do, mask = _inputs(case, seed=1)
    b, hq, hkv, sq, sk = case[:5]
    g = hq // hkv

    def f(q, k, v):
        out = _flash_xla(q.reshape(b, hkv, g, sq, -1), k, v,
                         causal=mask["causal"], window=mask["window"],
                         chunk=16)
        return jnp.sum(out.reshape(b, hq, sq, -1) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    o = ref.attention_ref(*(torch.from_numpy(a) for a in (q, k, v)), **mask)
    got = ref.attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                o, torch.from_numpy(do), **mask)
    for name, a, w in zip("qkv", got, want):
        _close(a, w, "d" + name)


@pytest.mark.parametrize("case", CASES[:4], ids=IDS[:4])
def test_ops_flash_attention_under_autograd(case):
    q, k, v, do, mask = _inputs(case, seed=2)
    del mask["kv_len"]
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, **mask)
    assert out.grad_fn is not None and "FlashAttention" in type(
        out.grad_fn).__name__
    out.backward(torch.from_numpy(do))
    plain = [torch.from_numpy(a) for a in (q, k, v)]
    o = ref.attention_ref(*plain, **mask)
    assert torch.equal(out.detach(), o)
    want = ref.attention_bwd_ref(*plain, o, torch.from_numpy(do), **mask)
    for t, w in zip((qt, kt, vt), want):
        assert torch.equal(t.grad, w)
    # no grad mode, or no input that requires one: the plain forward alone
    with torch.no_grad():
        assert ops.flash_attention(qt, kt, vt, **mask).grad_fn is None
    assert torch.equal(ops.flash_attention(*plain, **mask), o)


def test_flash_attention_fn_takes_a_key_length():
    q, k, v, do, mask = _inputs(CASES[4], seed=3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ops.flash_attention_fn(qt, kt, vt, **mask)
    out.backward(torch.from_numpy(do))
    want = ref.attention_bwd_ref(*(torch.from_numpy(a) for a in (q, k, v)),
                                 out.detach(), torch.from_numpy(do), **mask)
    for t, w in zip((qt, kt, vt), want):
        assert torch.equal(t.grad, w)
    assert not kt.grad[:, :, 37:].any() and not vt.grad[:, :, 37:].any()


def _bf16(t):
    return t.to(torch.bfloat16).float()


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_rounding_bound_covers_bf16_operands(case):
    """The kernel's bf16 arithmetic in plain torch: P rounded to bf16 in
    ``P^T do``, dS rounded in ``dS^T q`` and ``dS K``; each result lies
    within the bound of the float32 gradient (all inputs bf16 values)."""
    q, k, v, do, mask = _inputs(case, d=32, seed=4)
    qb, kb, vb, dob = (_bf16(torch.from_numpy(a)) for a in (q, k, v, do))
    o = _bf16(ref.attention_ref(qb, kb, vb, **mask))
    want = ref.attention_bwd_ref(qb, kb, vb, o, dob, **mask)
    bound = ref.attention_bwd_rounding_bound(qb, kb, vb, o, dob, **mask)
    b, hq, sq, d = qb.shape
    hkv = kb.shape[1]
    p, ds, qf, kf, dof = ref._attention_bwd_parts(qb, kb, vb, o, dob, **mask)
    dv = _bf16(p).transpose(-1, -2) @ dof
    dk = (_bf16(ds).transpose(-1, -2) @ qf) / d ** 0.5
    dq = ((_bf16(ds) @ kf) / d ** 0.5).reshape(b, hq, sq, d)
    for got, w, bd in zip((dq, dk, dv), want, bound):
        assert bd.shape == w.shape and (bd >= 0).all()
        assert ((got - w).abs() <= bd + 1e-6).all()
    assert (bound[2] > 0).any() and hkv <= hq


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bwd_ref_given_lse_is_the_same_bits(case):
    """``attention_lse`` is what ``attention_bwd_ref`` computes itself,
    +inf on the rows that keep no key (window, ``kv_len``), so the
    gradients given it are the same bits."""
    q, k, v, do, mask = _inputs(case, seed=5)
    q, k, v, do = (torch.from_numpy(a) for a in (q, k, v, do))
    o = ref.attention_ref(q, k, v, **mask)
    lse = ref.attention_lse(q, k, **mask)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    keeps = ref._attention_mask(q.shape[2], k.shape[2], device="cpu",
                                **mask).any(-1)
    assert torch.equal(torch.isinf(lse), ~keeps.expand(lse.shape))
    assert bool((lse[:, :, keeps] > -float("inf")).all())
    if case[7] == 3:
        assert not keeps[7:].any() and bool((lse[:, :, 7:] == float(
            "inf")).all())
    want = ref.attention_bwd_ref(q, k, v, o, do, **mask)
    got = ref.attention_bwd_ref(q, k, v, o, do, lse=lse, **mask)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("case", [c for c in CASES if c[7] is None],
                         ids=[i for c, i in zip(CASES, IDS) if c[7] is None])
def test_bwd_ref_given_lse_matches_jax_grad_of_flash_xla(case):
    """The gradients from the forward's lse against ``jax.grad`` of the
    JAX package's blockwise attention, within ``TOL``."""
    q, k, v, do, mask = _inputs(case, seed=6)
    b, hq, hkv, sq, sk = case[:5]
    g = hq // hkv

    def f(q, k, v):
        out = _flash_xla(q.reshape(b, hkv, g, sq, -1), k, v,
                         causal=mask["causal"], window=mask["window"],
                         chunk=16)
        return jnp.sum(out.reshape(b, hq, sq, -1) * do)
    want = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    plain = [torch.from_numpy(a) for a in (q, k, v)]
    o = ref.attention_ref(*plain, **mask)
    lse = ref.attention_lse(plain[0], plain[1], **mask)
    got = ref.attention_bwd_ref(*plain, o, torch.from_numpy(do), lse=lse,
                                **mask)
    for name, a, w in zip("qkv", got, want):
        _close(a, w, "d" + name)


# (batch, q heads, kv heads, seq): the training shapes and the moe
# prefill's MHA shape; heads a dK/dV chunk the host should pick
CHUNK_SHAPES = {"internvl2-1b": ((2, 14, 2, 4352), 4),
                "glm4-9b": ((1, 32, 2, 4096), 3),
                "deepseek-moe-16b": ((2, 16, 16, 4096), 1)}


@pytest.mark.parametrize("name", list(CHUNK_SHAPES))
def test_dkdv_work_items_fill_the_card(name):
    """At least 4 items an SM of an H100 (132) at both training shapes, by
    splitting a group's heads into chunks of about equal size; one chunk
    fewer (of the next larger size) would not reach them; no split, and no
    sum of chunks, where the items already suffice."""
    (b, hq, hkv, s), want = CHUNK_SHAPES[name]
    heads = flash.dkdv_heads_per_chunk(b, hq, hkv, s)
    assert heads == want
    g = hq // hkv
    chunks = -(-g // heads)
    items = b * hkv * (s // flash.DKDV_KEYS) * chunks
    assert items >= flash.ITEMS_PER_SM * flash.H100_SMS
    if heads < g:   # fewer chunks would not reach them
        fewer = -(-g // (chunks - 1))
        assert b * hkv * (s // 64) * -(-g // fewer) < 4 * 132
    kernels = flash.bwd_kernels(torch.bfloat16, b, hq, hkv, s)
    assert kernels == (("bwd_dq_wgmma", "bwd_dkdv_wgmma", "bwd_dkdv_sum")
                       if chunks > 1 else ("bwd_dq_wgmma", "bwd_dkdv_wgmma"))
    assert flash.bwd_kernels(torch.float32, b, hq, hkv, s) == (
        "bwd_dq", "bwd_dkdv")
    # a group already large enough in items stays whole
    assert flash.dkdv_heads_per_chunk(b, hq, hkv, s, sms=1) == g
