"""Attention of the dense decoder: GQA + RoPE + sliding window.

A port of the full-sequence path of the JAX package's
``models/attention.py`` (train / prefill).  ``cfg.attn_impl`` picks the
path, as ``attention.py:188-217`` of the JAX package does:

* ``pallas`` goes to ``ops.flash_attention``: on a CUDA tensor the
  hand-written kernel (``kernels/csrc/flash_attention.cu``), on a CPU
  tensor its plain version;
* ``xla_full``, or any path with ``sq * sk <= 512 * 512``, goes to the
  naive float32 softmax below;
* ``xla_chunked`` (the default) above that size also goes to
  ``ops.flash_attention``.  The JAX package runs a pure-JAX online
  softmax there, "identical math to the Pallas kernel" in its own words;
  the port keeps one blockwise implementation per device.

Layouts: activations (B, S, D); q (B, S, Hq, Dh) and k/v (B, S, Hkv, Dh)
out of the projections; the kernel takes (B, H, S, Dh).  Grouped queries
never materialise repeated K/V.

Left out: the JAX ``sharding.constrain`` calls, which are no-ops without
a mesh (the port runs on one card); cross-attention (``kv_x``, the audio
family); and decode (``attention_decode``, ``init_kv_cache``), which
waits for the decode slice.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers
from ..kernels import ops as kernel_ops

NEG_INF = -1e30
ATTN_IMPLS = ("xla_chunked", "xla_full", "pallas")


class Attention(nn.Module):
    """``wq``/``wk``/``wv`` (with a bias if ``cfg.qkv_bias``), ``wo``, and
    RMSNorms of q and k over the head dim if ``cfg.qk_norm``."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        d, hq, hkv, dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.wq = layers.Linear(d, hq * dh, bias=cfg.qkv_bias, **kw)
        self.wk = layers.Linear(d, hkv * dh, bias=cfg.qkv_bias, **kw)
        self.wv = layers.Linear(d, hkv * dh, bias=cfg.qkv_bias, **kw)
        self.wo = layers.Linear(hq * dh, d, **kw)
        if cfg.qk_norm:
            self.q_norm = layers.RMSNorm(dh, device=device)
            self.k_norm = layers.RMSNorm(dh, device=device)
        else:
            self.q_norm = self.k_norm = None

    def forward(self, cfg, x, positions, *, causal=True, window=0):
        return attention(self, cfg, x, positions, causal=causal,
                         window=window)


def project_qkv(p: Attention, cfg, x: torch.Tensor):
    """-> q (B, S, Hq, Dh), k and v (B, S, Hkv, Dh)."""
    b, s, _ = x.shape
    q = p.wq(x).reshape(b, s, cfg.n_heads, cfg.head_dim)
    k = p.wk(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    v = p.wv(x).reshape(b, s, cfg.n_kv_heads, cfg.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    return q, k, v


def _grouped(q, k, v, hkv: int):
    """(B, S, H, D) -> q (B, Hkv, G, Sq, D), k and v (B, Hkv, Sk, D)."""
    b, sq, hq, d = q.shape
    q = q.transpose(1, 2).reshape(b, hkv, hq // hkv, sq, d)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def _naive(cfg, q, k, v, positions, *, causal, window):
    """Float32 softmax over every (query, key) pair; masks from the
    positions, masked scores at NEG_INF."""
    b, sq = q.shape[:2]
    qg, kg, vg = _grouped(q, k, v, cfg.n_kv_heads)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     kg.float()) / (cfg.head_dim ** 0.5)
    qpos = positions[:, None, None, :, None]
    kpos = positions[:, None, None, None, :]
    mask = torch.ones_like(s, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    pr = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    og = torch.einsum("bhgqk,bhkd->bhgqd", pr, vg.float())
    return og.reshape(b, cfg.n_heads, sq, cfg.head_dim).transpose(1, 2)


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
              *, causal: bool = True, window: int = 0) -> torch.Tensor:
    """Full-sequence self-attention (prefill).

    Args:
      x: (B, S, D) activations.
      positions: (B, S) int positions, for RoPE and the naive path's
        masks.  The blockwise path counts positions from 0, as the JAX
        kernel does; a prefill's positions are ``arange(S)``.

    Returns: (B, S, D) in x's dtype.
    """
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; the port "
                         f"takes {ATTN_IMPLS}")
    b, sq, _ = x.shape
    q, k, v = project_qkv(p, cfg, x)
    q = layers.apply_rope(q, positions, cfg.rope_theta)
    k = layers.apply_rope(k, positions, cfg.rope_theta)

    naive = cfg.attn_impl == "xla_full" or (
        cfg.attn_impl == "xla_chunked" and sq * k.shape[1] <= 512 * 512)
    if naive:
        out = _naive(cfg, q, k, v, positions, causal=causal,
                     window=window).to(x.dtype)
    else:
        heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
        out = kernel_ops.flash_attention(*heads, causal=causal,
                                         window=window).transpose(1, 2)
    return p.wo(out.reshape(b, sq, cfg.n_heads * cfg.head_dim))
