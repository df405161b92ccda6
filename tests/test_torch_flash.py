"""Parity of the port's attention (``ops.flash_attention``) with the JAX
package's, on the CPU.

The same numpy inputs go through the port (on a CPU tensor:
``ref.attention_ref``, the plain version the CUDA kernel is held against
on the card) and through both JAX functions: the Pallas kernel in
interpret mode and the oracle ``ref.attention_ref``.  The grid is the JAX
package's own (``tests/test_kernels.py``: MHA, GQA, MQA at 384; causal,
window 128, none) plus head dims 80 and 128 and a q:kv group of 16.
Tolerances are the JAX package's: float32 within 2e-4 abs and rel, bf16
within 3e-2 (one bf16 ulp at 4 is 3.1e-2; the inputs are standard
normals and the outputs averages of them).

Where queries and keys differ in length under a mask, the JAX kernel
(query positions from 0) and the JAX oracle (right-aligned) disagree;
the port raises there rather than pick one.

The card's bf16 kernel rounds P to bf16 before its product with V.  Its
arithmetic, emulated here in plain torch, lies within
``ref.attention_rounding_bound`` of the float32 plain version on the
same grid.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.configs import ARCH_NAMES, get_config
from repro_torch.kernels import flash_attention as flash, ops, ref

SHAPES = [(1, 4, 4, 256, 64),     # MHA
          (2, 8, 2, 256, 64),     # GQA
          (1, 8, 1, 384, 128),    # MQA, 384 = 3 x 128
          (1, 4, 2, 256, 80),     # head dim 80 (zamba2)
          (1, 16, 1, 256, 128)]   # a q:kv group of 16 (glm4-9b: 32:2)
MASKS = [(True, 0), (True, 128), (False, 0)]


def _inputs(b, hq, hkv, s, d, *, seed, sk=None):
    rng = np.random.default_rng(seed)
    sk = s if sk is None else sk
    q = rng.normal(size=(b, hq, s, d)).astype(np.float32)
    k = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    v = rng.normal(size=(b, hkv, sk, d)).astype(np.float32)
    return q, k, v


def _jax(q, k, v, dtype=jnp.float32, **kw):
    qj, kj, vj = (jnp.asarray(a).astype(dtype) for a in (q, k, v))
    kernel = jops.flash_attention(qj, kj, vj, backend="interpret", **kw)
    oracle = jref.attention_ref(qj, kj, vj, **kw)
    return (np.asarray(kernel.astype(jnp.float32)),
            np.asarray(oracle.astype(jnp.float32)))


def _port(q, k, v, dtype=torch.float32, **kw):
    qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    out = ops.flash_attention(qt, kt, vt, **kw)
    assert out.dtype == dtype and out.shape == qt.shape
    return out.float().numpy()


@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_f32_matches_jax_kernel_and_oracle(b, hq, hkv, s, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, s, d, seed=b + s + d)
    got = _port(q, k, v, causal=causal, window=window)
    kernel, oracle = _jax(q, k, v, causal=causal, window=window)
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("b,hq,hkv,s,d", [(1, 4, 2, 256, 64),
                                          (1, 16, 1, 256, 128)])
@pytest.mark.parametrize("causal,window", MASKS)
def test_bf16_matches_jax_kernel_and_oracle(b, hq, hkv, s, d, causal, window):
    q, k, v = _inputs(b, hq, hkv, s, d, seed=9)
    got = _port(q, k, v, torch.bfloat16, causal=causal, window=window)
    kernel, oracle = _jax(q, k, v, jnp.bfloat16, causal=causal,
                          window=window)
    np.testing.assert_allclose(got, kernel, rtol=3e-2, atol=3e-2)
    np.testing.assert_allclose(got, oracle, rtol=3e-2, atol=3e-2)


def test_causal_window_one_keeps_only_the_diagonal():
    """Causal keeps kpos <= qpos, window 1 keeps kpos > qpos - 1: each
    query sees its own key alone, so its output is that key's value row,
    exactly (p = exp(0) = 1, l = 1), in the port and in both JAX
    functions."""
    q, k, v = _inputs(1, 2, 1, 128, 32, seed=3)
    got = _port(q, k, v, causal=True, window=1)
    want = np.broadcast_to(v, got.shape)
    np.testing.assert_array_equal(got, want)
    for out in _jax(q, k, v, causal=True, window=1):
        np.testing.assert_allclose(out, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("causal,window", [(True, 0), (False, 64),
                                           (True, 64)])
def test_unequal_lengths_under_a_mask_raise_where_jax_disagrees(causal,
                                                                window):
    q, k, v = _inputs(1, 2, 2, 128, 32, seed=1, sk=256)
    kernel, oracle = _jax(q, k, v, causal=causal, window=window)
    assert np.abs(kernel - oracle).max() > 0.1
    with pytest.raises(ValueError, match="as many queries as keys"):
        _port(q, k, v, causal=causal, window=window)


def test_unequal_lengths_without_a_mask_agree():
    q, k, v = _inputs(1, 4, 2, 128, 64, seed=2, sk=256)
    got = _port(q, k, v, causal=False, window=0)
    kernel, oracle = _jax(q, k, v, causal=False, window=0)
    np.testing.assert_allclose(got, kernel, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(got, oracle, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("sq,sk", [(1000, 1500), (4096, 1500), (300, 65),
                                   (130, 1), (256, 129)])
def test_pad_ragged_bounds_the_padded_keys(sq, sk):
    """No mask over ragged lengths (whisper's encoder and cross-attention
    over 1500 frames): ``ops.pad_ragged`` pads q by its own length and k/v
    by theirs to multiples of 128 and passes ``kv_len`` = sk; with
    ``ref.attention_ref`` (which takes the bound as the kernel does) as
    the inner function, the result is ``attention_ref`` on the unpadded
    inputs within 1e-6 in float32, and the JAX oracle's within 2e-4."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 4, 2, sq, 64,
                                                    seed=sq + sk, sk=sk))
    seen = []

    def inner(*a, **kw):
        seen.append((a[0].shape[2], a[1].shape[2], kw["kv_len"]))
        return ref.attention_ref(*a, **kw)
    got = ops.pad_ragged(inner, q, k, v, causal=False, window=0)
    want = ref.attention_ref(q, k, v, causal=False)
    assert seen == [(-(-sq // 128) * 128, -(-sk // 128) * 128, sk)]
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
    if sq * sk <= 1000 * 1500:
        oracle = jref.attention_ref(*(jnp.asarray(t.numpy())
                                      for t in (q, k, v)), causal=False)
        np.testing.assert_allclose(got.numpy(), np.asarray(oracle),
                                   rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("kv_len", [1, 63, 64, 65, 127, 129, 200])
@pytest.mark.parametrize("causal", [False, True])
def test_key_length_bound_is_the_unpadded_call(kv_len, causal):
    """``attention_ref(..., kv_len=n)`` on K/V whose keys past n are
    random (padding that would show if attended to) equals the call on the
    first n keys alone; causal over equal lengths, on the first n rows
    (the padded rows see the first n keys)."""
    sk = -(-kv_len // 128) * 128
    q, k, v = (torch.from_numpy(a) for a in _inputs(
        1, 4, 2, sk if causal else 256, 64, seed=kv_len, sk=sk))
    got = ref.attention_ref(q, k, v, causal=causal, kv_len=kv_len)
    rows = kv_len if causal else q.shape[2]
    want = ref.attention_ref(q[:, :, :rows], k[:, :, :kv_len],
                             v[:, :, :kv_len], causal=causal)
    torch.testing.assert_close(got[:, :, :rows], want, rtol=0, atol=1e-6)
    if causal:      # a padded row sees every real key
        torch.testing.assert_close(
            got[:, :, rows:], ref.attention_ref(
                q[:, :, rows:], k[:, :, :kv_len], v[:, :, :kv_len],
                causal=False), rtol=0, atol=1e-6)
    bound = ref.attention_rounding_bound(q.bfloat16(), k.bfloat16(),
                                         v.bfloat16(), causal=causal,
                                         kv_len=kv_len)
    assert bound.shape == got.shape
    for bad in (0, sk + 1):
        with pytest.raises(ValueError, match="kv_len"):
            ref.attention_ref(q, k, v, causal=causal, kv_len=bad)


def test_backends_resolve_by_device_and_never_fall_back():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 2, 1, 128, 32,
                                                    seed=4))
    want = ops.flash_attention(q, k, v)
    for name in ("ref", "interpret", "auto"):
        assert torch.equal(ops.flash_attention(q, k, v, backend=name), want)
    for name in ("cuda", "pallas"):
        with pytest.raises(ValueError, match="needs CUDA tensors"):
            ops.flash_attention(q, k, v, backend=name)
    with pytest.raises(ValueError, match="must be a CUDA tensor"):
        flash.flash_attention_cuda(q, k, v)
    with pytest.raises(ValueError, match="unknown backend"):
        ops.flash_attention(q, k, v, backend="xla")


def test_plain_version_refuses_a_bad_group():
    q, k, v = (torch.from_numpy(a) for a in _inputs(1, 3, 2, 128, 32,
                                                    seed=5))
    with pytest.raises(ValueError, match="multiple of kv_heads"):
        ops.flash_attention(q, k, v)


def _emulate_wgmma_bf16(q, k, v, *, causal, window, block_k=128):
    """The Hopper kernel's arithmetic in plain float32 torch: per tile of
    128 keys the scores times ``scale * log2(e)`` (one float32), the
    base-2 online softmax from the JAX kernel's NEG_INF, masked scores at
    -inf, ``l`` summed from the float32 p, and p rounded to bf16 (to
    nearest even) before its product with v.  Returns the float32 result
    that the kernel rounds to bf16."""
    b, hq, sq, d = q.shape
    g = hq // k.shape[1]
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    c = torch.tensor(1.0 / d ** 0.5) * torch.tensor(1.4426950408889634)
    m = torch.full((b, hq, sq), -1e30)
    l = torch.zeros((b, hq, sq))
    acc = torch.zeros((b, hq, sq, d))
    qpos = torch.arange(sq)[:, None]
    for k0 in range(0, k.shape[2], block_k):
        s = q.float() @ kf[:, :, k0:k0 + block_k].transpose(-1, -2)
        kpos = torch.arange(k0, k0 + block_k)[None, :]
        keep = torch.ones((sq, block_k), dtype=torch.bool)
        if causal:
            keep &= kpos <= qpos
        if window > 0:
            keep &= kpos > qpos - window
        s = s.masked_fill(~keep, float("-inf"))
        m_new = torch.maximum(m, s.amax(-1) * c)
        alpha = torch.exp2(m - m_new)
        p = torch.exp2(s * c - m_new[..., None])
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + (p.bfloat16().float()
                                        @ vf[:, :, k0:k0 + block_k])
        m = m_new
    return acc / torch.where(l == 0, 1.0, l)[..., None]


@pytest.mark.parametrize("b,hq,hkv,s,d", SHAPES)
@pytest.mark.parametrize("causal,window", MASKS)
def test_bf16_p_rounding_lies_within_the_stated_bound(b, hq, hkv, s, d,
                                                      causal, window):
    """The kernel's arithmetic on bf16 inputs against the float32 plain
    version of the same inputs: every element within
    ``ref.attention_rounding_bound``, which the card's bf16 tolerance adds
    to 2e-4 and one bf16 step."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(b, hq, hkv, s, d, seed=b + s + d))
    got = _emulate_wgmma_bf16(q, k, v, causal=causal, window=window)
    want = ref.attention_ref(q.float(), k.float(), v.float(), causal=causal,
                             window=window)
    bound = ref.attention_rounding_bound(q, k, v, causal=causal,
                                         window=window)
    assert bound.dtype == torch.float32 and bound.shape == want.shape
    assert bool(((got - want).abs() <= bound).all())
    assert bool((got != want).any())      # the rounding of P shows


def test_bf16_p_rounding_keeps_a_single_key_exact():
    """Causal with window 1 keeps each query's own key alone: p = 1 (exact
    in bf16), l = 1, so the emulated kernel returns v exactly, and the
    bound there is 2^-8 |v|."""
    q, k, v = (torch.from_numpy(a).bfloat16()
               for a in _inputs(1, 4, 2, 256, 128, seed=6))
    got = _emulate_wgmma_bf16(q, k, v, causal=True, window=1)
    want = v.float().repeat_interleave(2, dim=1)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        ref.attention_rounding_bound(q, k, v, causal=True, window=1),
        2.0 ** -8 * want.abs(), rtol=0, atol=0)


def test_dispatch_is_explicit_by_dtype_and_head_dim():
    """bf16 at every head dim of the configs (32, 64, 80 and 128, full
    width and SMOKE) goes to the Hopper kernel; all float32 to the
    CUDA-core kernel."""
    assert flash.WGMMA_HEAD_DIMS == (32, 64, 80, 128)
    assert flash.VARIANTS == ("wgmma_bf16", "cuda_core_f32")
    for d in flash.HEAD_DIMS:
        assert flash.variant(torch.float32, d) == "cuda_core_f32"
        assert flash.variant(torch.bfloat16, d) == "wgmma_bf16"
    assert set(flash.launches_by_variant) == set(flash.VARIANTS)
    head_dims = {get_config(n, smoke=smoke).head_dim for n in ARCH_NAMES
                 for smoke in (False, True)
                 if get_config(n).family not in ("ssm",)}
    assert head_dims == {32, 64, 80, 128}
