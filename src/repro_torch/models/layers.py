"""Shared neural layers of the dense decoder: norms, linear maps, embedding,
MLPs and RoPE.

A port of the JAX package's ``models/layers.py`` as ``nn.Module``s, with
its numerics:

* weights keep the JAX layout, ``(d_in, d_out)``, so ``y = x @ w``, and
  are cast to the activations' dtype (bf16, :data:`COMPUTE_DTYPE`) at each
  use.  The JAX package stores them in float32; here they may be stored
  in bf16 (``dtype=``), which gives the same products: JAX's
  ``astype(bfloat16)`` and ``Tensor.to(torch.bfloat16)`` both round to
  nearest even, so a weight rounded once at load equals one rounded at
  each use;
* RMSNorm computes in float32 with a float32 scale, whatever the storage
  dtype of the other weights;
* RoPE rotates the two HALVES of each head (``jnp.split(x, 2)``), not
  interleaved pairs;
* the activations are JAX's, op by op in x's dtype: ``jax.nn.silu`` is
  ``x * sigmoid(x)``, and XLA writes the bf16 sigmoid out as ``1 / (1 +
  exp(-x))``, each step rounded to bf16; ``jax.nn.gelu`` is the tanh
  approximation (``torch.nn.functional.gelu`` defaults to erf) with its
  constants rounded to x's dtype.  One fused float32 activation would
  round once and differ from the JAX package in about 40 % of the bf16
  outputs; written out, the two agree bit for bit on the CPU.
  ``jax.nn.softplus`` and ``log_sigmoid`` (the ssm family's gates) are
  written out the same way, as ``jnp.logaddexp`` computes them: they
  agree bit for bit wherever torch's ``exp`` and ``log1p`` agree with
  XLA's on the same operands (those differ by an ulp in places).

Parameters do not require gradients: the port has no backward for its
attention kernel yet.  The losses wait for the training slice.
"""

from __future__ import annotations

import math

import torch
from torch import nn

COMPUTE_DTYPE = torch.bfloat16


def normal(shape, scale: float, *, generator, device, dtype) -> torch.Tensor:
    """``N(0, 1) * scale`` drawn in float32 from ``generator``, stored in
    ``dtype``; uninitialised on the meta device."""
    if torch.device(device).type == "meta":
        return torch.empty(shape, device="meta", dtype=dtype)
    w = torch.randn(shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def dense_init(shape, *, generator, device, dtype) -> torch.Tensor:
    """The JAX package's ``_dense_init``: a ``fan_in ** -0.5`` normal,
    ``fan_in = shape[0]``."""
    return normal(shape, shape[0] ** -0.5, generator=generator,
                  device=device, dtype=dtype)


def frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class RMSNorm(nn.Module):
    """``x * rsqrt(mean(x^2) + eps) * scale`` in float32, returned in x's
    dtype.  ``scale`` (d,) is float32, initialised to ones."""

    def __init__(self, d: int, *, device, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.scale = frozen(torch.ones(d, dtype=torch.float32,
                                        device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.float()
        var = (xf * xf).mean(dim=-1, keepdim=True)
        return (xf * torch.rsqrt(var + self.eps) * self.scale).to(x.dtype)


class Linear(nn.Module):
    """``y = x @ w + b`` with ``w`` (d_in, d_out), the JAX layout, and an
    optional bias (zeros at init); both cast to x's dtype at use."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool = False,
                 generator=None, device, dtype):
        super().__init__()
        self.w = frozen(dense_init((d_in, d_out), generator=generator,
                                    device=device, dtype=dtype))
        self.b = (frozen(torch.zeros(d_out, dtype=dtype, device=device))
                  if bias else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x @ self.w.to(x.dtype)
        if self.b is not None:
            y = y + self.b.to(x.dtype)
        return y


class Embedding(nn.Module):
    """The token table (vocab, d), 0.02-normal at init, used both ways:
    :meth:`forward` looks tokens up, :meth:`unembed` gives tied logits."""

    def __init__(self, vocab: int, d: int, *, generator=None, device, dtype):
        super().__init__()
        self.table = frozen(normal((vocab, d), 0.02, generator=generator,
                                    device=device, dtype=dtype))

    def forward(self, tokens: torch.Tensor,
                dtype: torch.dtype = COMPUTE_DTYPE) -> torch.Tensor:
        # the JAX package casts the table, then gathers; row by row the same
        return self.table[tokens].to(dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Logits against the table: ``x @ table.T`` in x's dtype."""
        return x @ self.table.to(x.dtype).T


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    operation rounded to x's dtype, as the JAX package computes it."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x)``, which is ``jnp.logaddexp(x, 0)``: ``max(x,
    0) + log1p(exp(-|x|))`` op by op in x's dtype (NaN where x is NaN).
    ``torch.nn.functional.softplus`` is another formula: ``log1p(exp(x))``
    below its threshold 20, ``x`` above it."""
    out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
    return torch.where(torch.isnan(x), x, out)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid(x)``: ``-softplus(-x)``."""
    return -softplus(-x)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu(x)`` (tanh approximation), op by op in x's dtype."""
    c = torch.tensor(0.044715, dtype=x.dtype).item()
    sqrt_2_over_pi = torch.tensor((2 / math.pi) ** 0.5, dtype=x.dtype).item()
    inner = x + c * (x * x * x)
    return x * (0.5 * (1.0 + torch.tanh(sqrt_2_over_pi * inner)))


class MLP(nn.Module):
    """``swiglu``: ``(silu(x @ wi) * (x @ wg)) @ wo``; ``gelu``:
    ``gelu_tanh(x @ wi) @ wo``.  Weights (d_model, d_ff) and (d_ff,
    d_model), as in the JAX package."""

    def __init__(self, d_model: int, d_ff: int, mlp_type: str, *,
                 generator=None, device, dtype):
        super().__init__()
        if mlp_type not in ("swiglu", "gelu"):
            raise ValueError(mlp_type)
        self.mlp_type = mlp_type
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wi = frozen(dense_init((d_model, d_ff), **kw))
        self.wg = (frozen(dense_init((d_model, d_ff), **kw))
                   if mlp_type == "swiglu" else None)
        self.wo = frozen(dense_init((d_ff, d_model), **kw))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x @ self.wi.to(x.dtype)
        if self.mlp_type == "swiglu":
            h = silu(h) * (x @ self.wg.to(x.dtype))
        else:
            h = gelu_tanh(h)
        return h @ self.wo.to(x.dtype)


def rope_freqs(head_dim: int, theta: float,
               device=None) -> torch.Tensor:
    """``theta ** (-arange(0, head_dim, 2) / head_dim)`` in float32."""
    exps = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding of the two halves of each head.

    x: (..., seq, heads, head_dim); positions: (..., seq).  Computed in
    float32, returned in x's dtype.
    """
    inv = rope_freqs(x.shape[-1], theta, device=x.device)       # (d/2,)
    ang = positions[..., :, None].float() * inv                 # (..., s, d/2)
    cos = torch.cos(ang)[..., None, :]                          # (..., s, 1, d/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)
