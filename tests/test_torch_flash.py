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
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as jops, ref as jref
from repro_torch.kernels import flash_attention as flash, ops

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
