"""Attention of the decoder: GQA + RoPE + sliding window.

A port of the JAX package's ``models/attention.py``: the full-sequence
path (train / prefill) and single-token decode against a KV cache
(:func:`init_kv_cache`, :func:`attention_decode`).  For the full
sequence ``cfg.attn_impl`` picks the path, as ``attention.py:188-217``
of the JAX package does:

* ``pallas`` goes to ``ops.flash_attention``: on a CUDA tensor the
  hand-written kernel (``kernels/csrc/flash_attention.cu``), on a CPU
  tensor its plain version;
* ``xla_full``, or any path with ``sq * sk <= 512 * 512``, goes to the
  naive float32 softmax below;
* ``xla_chunked`` (the default) above that size also goes to
  ``ops.flash_attention``.  The JAX package runs a pure-JAX online
  softmax there, "identical math to the Pallas kernel" in its own words,
  at any length; the port keeps one blockwise implementation per device
  and on the card pads a call of lengths that are not multiples of 128
  to the next ones, the padded keys masked by the kernel's key-length
  bound (``ops.pad_ragged``: exact).  ``pallas`` takes multiples of 128
  only, as the JAX kernel does.

Cross-attention (the audio family's decoder over the encoder's output)
is the same function with ``kv_x``: keys and values are projected from
``kv_x``, the naive path's masks read ``kv_positions``, and RoPE is
skipped under ``use_rope=False``.

Layouts: activations (B, S, D); q (B, S, Hq, Dh) and k/v (B, S, Hkv, Dh)
out of the projections; the kernel takes (B, H, S, Dh).  Grouped queries
never materialise repeated K/V.  A KV cache is (B, L, Hkv, Dh), a ring
buffer of the last L tokens under a sliding window.  Decode attention is
plain torch, as it is plain ``jnp`` in the JAX package: float32 scores
and softmax over the whole cache.

Under a mesh (``models/sharding.py``'s rules installed, the activations
``DTensor``s) the attention output is constrained as the JAX package's
is, and the softmax or the kernel runs on each rank's rows and heads
(:func:`_attend_local`).
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers, sharding
from .sharding import constrain
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


def project_qkv(p: Attention, cfg, x: torch.Tensor,
                kv_x: torch.Tensor | None = None):
    """-> q (B, Sq, Hq, Dh) from x, k and v (B, Sk, Hkv, Dh) from ``kv_x``
    (cross-attention) or x."""
    b, sq, _ = x.shape
    kv_x = x if kv_x is None else kv_x
    sk = kv_x.shape[1]
    q = sharding.unflatten(p.wq(x), cfg.n_heads, cfg.head_dim)
    k = sharding.unflatten(p.wk(kv_x), cfg.n_kv_heads, cfg.head_dim)
    v = sharding.unflatten(p.wv(kv_x), cfg.n_kv_heads, cfg.head_dim)
    if p.q_norm is not None:
        q = p.q_norm(q)
        k = p.k_norm(k)
    return q, k, v


def _grouped(q, k, v, hkv: int):
    """(B, S, H, D) -> q (B, Hkv, G, Sq, D), k and v (B, Hkv, Sk, D)."""
    b, sq, hq, d = q.shape
    q = q.transpose(1, 2).reshape(b, hkv, hq // hkv, sq, d)
    return q, k.transpose(1, 2), v.transpose(1, 2)


def _naive(cfg, q, k, v, positions, kv_positions, *, causal, window,
           hkv=None):
    """Float32 softmax over every (query, key) pair; masks from the
    positions, masked scores at NEG_INF.  ``hkv``: the kv heads k and v
    hold (default ``cfg.n_kv_heads``; fewer on a rank's local heads)."""
    b, sq, hq = q.shape[:3]
    qg, kg, vg = _grouped(q, k, v, hkv or cfg.n_kv_heads)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(),
                     kg.float()) / (cfg.head_dim ** 0.5)
    qpos = positions[:, None, None, :, None]
    kpos = kv_positions[:, None, None, None, :]
    mask = torch.ones_like(s, dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    pr = torch.softmax(torch.where(mask, s, NEG_INF), dim=-1)
    og = torch.einsum("bhgqk,bhkd->bhgqd", pr, vg.float())
    return og.reshape(b, hq, sq, cfg.head_dim).transpose(1, 2)


def attention(p: Attention, cfg, x: torch.Tensor, positions: torch.Tensor,
              *, causal: bool = True, window: int = 0,
              kv_x: torch.Tensor | None = None,
              kv_positions: torch.Tensor | None = None,
              use_rope: bool = True) -> torch.Tensor:
    """Full-sequence attention (prefill, encoder, cross-attention).

    Args:
      x: (B, Sq, D) the queries' activations.
      positions: (B, Sq) int positions, for RoPE and the naive path's
        masks.  The blockwise path counts positions from 0, as the JAX
        kernel does; a prefill's positions are ``arange(S)``.
      kv_x: (B, Sk, D), the keys' and values' activations in
        cross-attention (default x).
      kv_positions: (B, Sk) the keys' positions (default ``positions``).
      use_rope: rotate q and k (cross-attention does not).

    Returns: (B, Sq, D) in x's dtype.
    """
    if cfg.attn_impl not in ATTN_IMPLS:
        raise ValueError(f"unknown attn_impl {cfg.attn_impl!r}; the port "
                         f"takes {ATTN_IMPLS}")
    b, sq, _ = x.shape
    q, k, v = project_qkv(p, cfg, x, kv_x)
    kv_positions = positions if kv_positions is None else kv_positions
    if use_rope:
        q = layers.apply_rope(q, positions, cfg.rope_theta)
        k = layers.apply_rope(k, kv_positions, cfg.rope_theta)

    out = _attend_local(cfg, q, k, v, positions, kv_positions,
                        causal=causal, window=window)
    out = constrain(out, "batch", "seq", "heads", None)
    return p.wo(sharding.flatten(out))


def _attend(cfg, q, k, v, positions, kv_positions, *, causal, window):
    """q (B, Sq, Hq, Dh), k and v (B, Sk, Hkv, Dh) -> (B, Sq, Hq, Dh) in
    q's dtype: the naive float32 softmax or the blockwise kernel, by
    ``cfg.attn_impl`` and the lengths."""
    sq, hkv = q.shape[1], k.shape[2]
    naive = cfg.attn_impl == "xla_full" or (
        cfg.attn_impl == "xla_chunked" and sq * k.shape[1] <= 512 * 512)
    if naive:
        return _naive(cfg, q, k, v, positions, kv_positions, causal=causal,
                      window=window, hkv=hkv).to(q.dtype)
    heads = [t.transpose(1, 2).contiguous() for t in (q, k, v)]
    return kernel_ops.flash_attention(
        *heads, causal=causal, window=window,
        ragged=cfg.attn_impl == "xla_chunked").transpose(1, 2)


def _attend_local(cfg, q, k, v, positions, kv_positions, *, causal,
                  window):
    """:func:`_attend` on each rank's rows and heads: q placed as the JAX
    package's ``constrain`` at its ``attention.py:219`` places the output
    (batch on the batch axes, heads on 'model', split as
    ``sharding.constrain`` splits an uneven count), k and v on the same
    kv heads where both counts divide 'model' (``sharding.local``), so
    the blockwise kernel runs on each rank's local heads.  Otherwise the
    kv heads stay whole on every rank, and each rank takes the ones its
    query heads read; a rank past the last query head attends with none.
    Without a mesh, :func:`_attend` itself."""
    m = sharding.axis_size("heads")
    aligned = cfg.n_heads % m == 0 and cfg.n_kv_heads % m == 0
    kv_heads = "kv_heads" if aligned else None
    g = cfg.n_heads // cfg.n_kv_heads

    def body(q, k, v, positions, kv_positions):
        if not aligned:
            # the kv heads that this rank's query heads read, in order,
            # each once where every one of them serves as many
            first, n = sharding.local_share("heads", cfg.n_heads)
            idx = [(first + j) // g for j in range(n)]
            if len({idx.count(i) for i in idx}) == 1:
                idx = list(dict.fromkeys(idx))
            k, v = (t[:, :, torch.tensor(idx, dtype=torch.long,
                                         device=t.device)] for t in (k, v))
            if n == 0:
                # nothing to attend; k and v stay in the graph, so that
                # every rank's backward runs the same collectives
                return q + (k.sum() + v.sum()).to(q.dtype)
        return _attend(cfg, q, k, v, positions, kv_positions, causal=causal,
                       window=window)
    rows = ("batch", None)
    # where each rank reads some of whole kv heads, its gradient of them
    # is its part of a sum over 'model'
    return sharding.local(
        body, ("batch", None, "heads", None), ("batch", None, "heads", None),
        ("batch", None, kv_heads, None), ("batch", None, kv_heads, None),
        rows, rows,
        partial_grads=None if aligned else {1: ("heads",), 2: ("heads",)})(
            q, k, v, sharding.distribute(positions, *rows),
            sharding.distribute(kv_positions, *rows))


def init_kv_cache(cfg, batch: int, length: int,
                  dtype: torch.dtype = layers.COMPUTE_DTYPE, *,
                  device) -> dict:
    """``{"k", "v"}``, each zeros of (batch, length, Hkv, Dh)."""
    shape = (batch, length, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention_decode(p: Attention, cfg, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, *, window: int = 0,
                     use_rope: bool = True):
    """Single-token decode against a KV cache.

    Args:
      x: (B, 1, D) current-token activations.
      cache: ``{"k", "v"}``, each (B, L, Hkv, Dh).  Under a sliding window
        L is the window and the cache a ring buffer (slot ``pos % L``);
        otherwise L is the longest sequence, and a position past it
        overwrites the last slot, as in the JAX package.
      pos: (B,) int absolute position of each row's new token.

    Returns (out (B, 1, D), cache).  The cache is updated IN PLACE (and
    returned): the new K and V (projected, then rotated) go into one slot
    a row.  The JAX function returns a new cache instead; a copy here
    would double a cache of tens of GB.
    """
    q, k, v = project_qkv(p, cfg, x)
    pos = pos.to(x.device)
    if use_rope:
        q = layers.apply_rope(q, pos[:, None], cfg.rope_theta)
        k = layers.apply_rope(k, pos[:, None], cfg.rope_theta)
    out = decode_attend(cfg, q, k, v, cache, pos, window=window)
    return p.wo(out.to(x.dtype)), cache


def groupable(cfg, q):
    """q (B, 1, Hq, Dh), whose heads each rank can split into (kv heads,
    group): on a mesh whose 'model' axis does not divide the kv heads,
    its heads gathered first (DTensor does not split an axis whose shards
    straddle the new ones; one token's q is small)."""
    if cfg.n_kv_heads % sharding.axis_size("kv_heads") == 0:
        return q
    return sharding.gathered(q, 2)


def _write(ck, cv, k, v, slot):
    """k and v (B, 1, Hkv, Dh) into one slot a row of the caches ck and cv
    (B, L, Hkv, Dh), in place."""
    rows = torch.arange(slot.shape[0], device=slot.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)


def _rows(place: tuple) -> tuple:
    """The placements of a (B, ...) tensor split as the rows of a tensor
    of placements ``place``."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(Shard(0) if p == Shard(0) else Replicate() for p in place)


def decode_attend(cfg, q, k, v, cache: dict, pos: torch.Tensor, *,
                  window: int = 0) -> torch.Tensor:
    """The cache's part of decode attention: write k and v (B, 1, Hkv, Dh)
    into one slot a row of ``cache`` (in place), then attend q (B, 1, Hq,
    Dh) over the valid slots.  Returns (B, 1, Hq * Dh) float32.

    The slot is ``pos % L`` under a window (the ring buffer, every slot
    valid once written) and ``min(pos, L - 1)`` otherwise (slots up to
    ``pos`` valid).  Scores and softmax in float32, masked at NEG_INF.
    On a mesh each rank writes its rows into its part of the caches, k and
    v placed as the caches are, and attends with them
    (:func:`_attend_cache_local`).
    """
    b = q.shape[0]
    ck, cv = cache["k"], cache["v"]
    L = ck.shape[1]
    slot = pos % L if window > 0 else pos.clamp(max=L - 1)
    place = getattr(ck, "placements", ())       # () without a mesh
    sharding.local(_write, [None], *[place] * 4, _rows(place))(
        ck, cv, k, v, sharding.distribute(slot, "batch"))
    out = _attend_cache_local(cfg, q, ck, cv, pos, place, window=window)
    return out.reshape(b, 1, cfg.n_heads * cfg.head_dim)


def _attend_cache(cfg, q, ck, cv, pos, *, window, reduce=None):
    """q (B, 1, Hq, Dh) over the caches ck, cv (B, L, Hkv, Dh) -> (B, 1,
    Hq, Dh) float32.  ``reduce``: applied to the scores where each rank
    holds part of the head dim (their sum over the ranks)."""
    b, _, hq, d = q.shape
    L, hkv = ck.shape[1], ck.shape[2]
    # float32 (B, Hkv, L, Dh), laid out for the batched products: one pass
    # over the cache each, where a cast that kept the cache's layout would
    # be copied again inside the product
    kg, vg = (t.transpose(1, 2).to(
        torch.float32, memory_format=torch.contiguous_format)
        for t in (ck, cv))
    qg = q.transpose(1, 2).reshape(b, hkv, hq // hkv, 1, d)
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg.float(), kg)
    if reduce is not None:
        s = reduce(s)
    s = s / (cfg.head_dim ** 0.5)
    idx = torch.arange(L, device=q.device)[None, :]
    if window > 0:
        valid = idx < torch.clamp(pos[:, None] + 1, max=L)
    else:
        valid = idx <= pos[:, None]
    pr = torch.softmax(torch.where(valid[:, None, None, None, :], s,
                                   NEG_INF), dim=-1)
    og = torch.einsum("bhgqk,bhkd->bhgqd", pr, vg)
    return og.reshape(b, hq, 1, d).transpose(1, 2)


def _attend_cache_local(cfg, q, ck, cv, pos, place, *, window):
    """:func:`_attend_cache` on each rank's part of the caches, of
    placements ``place``, as the decode state's plan places them
    (``specs.decode_state_shardings``: the kv heads over 'model' where
    they divide it, else the head dim where it does), and the query heads
    that part serves: the scores of a split head dim are summed over
    'model' in one all-reduce a step, as XLA partitions the JAX einsum.
    Without a mesh (``place`` empty), :func:`_attend_cache` itself."""
    from torch.distributed.tensor import Replicate, Shard
    split_d = [i for i, p in enumerate(place) if p == Shard(3)]
    q_place = tuple(p if p in (Shard(0), Shard(2), Shard(3)) else Replicate()
                    for p in place)

    def reduce(s):
        from torch.distributed import _functional_collectives as funcol
        for i in split_d:
            s = funcol.all_reduce(s, "sum", (ck.device_mesh, i))
        return s

    def body(q, ck, cv, pos):
        return _attend_cache(cfg, q, ck, cv, pos, window=window,
                             reduce=reduce if split_d else None)
    return sharding.local(body, q_place, q_place, place, place,
                          _rows(place))(
        groupable(cfg, q), ck, cv, sharding.distribute(pos, "batch"))
