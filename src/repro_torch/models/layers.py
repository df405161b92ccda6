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

Parameters are made with ``requires_grad=False`` (:func:`frozen`), so
prefill and decode build no graph; the training entry points
(``launch/steps.py``) make them trainable.  The losses:
:func:`softmax_xent`, and :func:`softmax_xent_chunked` against the tied
table, which never holds the whole (B, S, V) logits.
"""

from __future__ import annotations

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .sharding import (Pending, axis_size, constrain, distribute, is_sharded,
                       local, local_index, operand)

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
        return _embed(self.table, tokens, dtype)

    def unembed(self, x: torch.Tensor) -> torch.Tensor:
        """Tied output projection: x (..., D) @ table.T -> (..., V)."""
        return x @ vocab_rows(self.table).to(x.dtype).T


def vocab_rows(table: torch.Tensor) -> torch.Tensor:
    """The token table placed as the logits it makes are constrained:
    its vocabulary split over 'model' (``sharding.operand``).  Where the
    plan leaves the table whole (a vocabulary that 'model' does not
    divide), each rank takes its rows and makes its own columns of the
    logits, as XLA partitions a product whose output is constrained;
    DTensor places a product by its operands alone.  A no-op where the
    plan splits the table already, or without a mesh."""
    return operand(table, "vocab", "embed")


def _embed(table, tokens, dtype):
    """The rows of ``table`` for ``tokens``, cast to ``dtype``.  On a mesh
    whose 'model' axis splits the vocabulary, each rank gathers the rows
    of its part, and 0 for a token another rank holds, so that the parts
    are a pending sum over 'model' (all-reduced where the model
    constrains the embedding, as XLA partitions the JAX gather); each
    rank's gradient of the table is its part of a sum over the batch."""
    vocab = "vocab" if table.shape[0] % axis_size("vocab") == 0 \
        and axis_size("vocab") > 1 else None

    def body(table, tokens):
        if vocab is None:
            # the JAX package casts the table, then gathers; row by row
            # the same
            return table[tokens].to(dtype)
        n = table.shape[0]
        ids = tokens.long() - local_index("vocab") * n
        hit = (ids >= 0) & (ids < n)
        rows = table[ids.clamp(0, n - 1)].to(dtype)
        return torch.where(hit[..., None], rows, 0)
    out = ("batch", None, None)
    return local(body, Pending(out, ("vocab",)) if vocab else out,
                 (vocab, None), ("batch", None),
                 partial_grads={0: ("batch",)})(table, tokens)


def _no_posinf(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isposinf(t), torch.zeros_like(t), t)


class _Softplus(torch.autograd.Function):
    """``max(x, 0) + log1p(exp(-|x|))`` with ``jnp.logaddexp``'s own
    derivative, ``exp(x - softplus(x))`` (+inf read as 0).  Autograd
    through the written-out form gives 1 at x == 0 exactly (``max``'s tie
    and ``|x|``'s kink) where the derivative is 1/2, and bf16 inputs land
    there often."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp_min(x, 0) + torch.log1p(torch.exp(-x.abs()))
        out = torch.where(torch.isnan(x), x, out)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_no_posinf(x) - _no_posinf(out))


def silu(x: torch.Tensor) -> torch.Tensor:
    """``x * sigmoid(x)`` with the sigmoid as ``1 / (1 + exp(-x))``, each
    operation rounded to x's dtype, as the JAX package computes it."""
    return x * (1 / (1 + torch.exp(-x)))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus(x)``, which is ``jnp.logaddexp(x, 0)``: ``max(x,
    0) + log1p(exp(-|x|))`` op by op in x's dtype (NaN where x is NaN),
    and its gradient as JAX takes it.
    ``torch.nn.functional.softplus`` is another formula: ``log1p(exp(x))``
    below its threshold 20, ``x`` above it."""
    return _Softplus.apply(x)


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
        h = constrain(h, *(("batch", "seq", "ff") if h.ndim == 3
                           else ("batch", "ff")))
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


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean token cross-entropy in float32; logits (..., V), labels (...)
    ints, ``mask`` (...) weights (the mean over its sum, at least 1)."""
    lse, ll = _lse_and_label(logits.float(), labels)
    nll = lse - ll
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _xent_sum(table: torch.Tensor, x: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """The summed cross-entropy of one chunk: logits ``x @ table.T`` in
    x's dtype, then float32."""
    logits = constrain((x @ vocab_rows(table).to(x.dtype).T).float(),
                       "batch", None, "vocab")
    lse, ll = _lse_and_label(logits, labels)
    return torch.sum(lse - ll)


def _lse_and_label(logits: torch.Tensor, labels: torch.Tensor):
    """(logsumexp over the last axis, the label's logit) of float32
    logits.  Where the logits are a ``DTensor`` sharded over the
    vocabulary, each rank reduces its own columns and the parts meet in
    all-reduces of (..., 1) rows: the max, the sum of exponentials, and
    the label's logit (one rank holds it, the others add 0), as XLA
    partitions the JAX package's ``logsumexp`` and ``take_along_axis``;
    the same formula as ``torch.logsumexp``'s, its sum split by rank."""
    if not is_sharded(logits):
        lse = torch.logsumexp(logits, dim=-1)
        return lse, logits.gather(-1, labels.long()[..., None])[..., 0]
    rows = ("batch",) + (None,) * (logits.ndim - 1)
    m = constrain(logits.detach().amax(-1, keepdim=True), *rows)
    total = constrain(torch.exp(logits - m).sum(-1, keepdim=True), *rows)
    lse = (torch.log(total) + m)[..., 0]
    iota = distribute(torch.arange(logits.shape[-1], device=logits.device),
                      "vocab")
    hit = labels.long()[..., None] == iota
    ll = constrain(torch.where(hit, logits, 0.0).sum(-1, keepdim=True),
                   *rows)[..., 0]
    return lse, ll


def softmax_xent_chunked(table: torch.Tensor, x: torch.Tensor,
                         labels: torch.Tensor,
                         chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy against a tied embedding table without holding
    the full (B, S, V) logits.

    x (B, S, D), labels (B, S).  The sequence goes in chunks of ``chunk``
    positions, shrunk until it divides S (as the JAX package does); the
    chunks' sums add in order from 0 and the total is divided by B * S.
    Under grad mode each chunk runs under ``torch.utils.checkpoint``: its
    logits are made again in the backward, so one chunk's logits are held
    at a time (the JAX package's ``jax.checkpoint`` on its scan body).
    """
    b, s, _ = x.shape
    c = chunk
    while s % c:
        c -= 1
    remat = torch.is_grad_enabled()
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, s, c):
        args = (table, x[:, i:i + c], labels[:, i:i + c])
        total = total + (checkpoint(_xent_sum, *args, use_reentrant=False)
                         if remat else _xent_sum(*args))
    return total / (b * s)
