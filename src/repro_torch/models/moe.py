"""Mixture-of-Experts layer: shared + routed experts, two dispatch modes.

A port of the JAX package's ``models/moe.py``:

* ``onehot`` (the baseline): the position of an assignment within its
  expert is a cumsum over a one-hot of the expert ids;
* ``sort``: the same positions from a stable argsort by expert id.

Both place each token's top-k assignments into an (E, C, D) buffer per
dispatch group, run the swiglu experts as batched products over E, and
combine each token's outputs with its renormalised router weights.  An
assignment beyond the capacity C of its expert is dropped: its weight is
0 and it WRITES NOTHING into the buffer.  Here the port departs from the
reference on purpose: the JAX package scatters zeros from a dropped
assignment into slot 0 of its expert (``moe.py:86-90``), on top of the
token kept there, so that token's routed output becomes 0 where the last
write wins (XLA:CPU) and is undefined where the order of duplicate
writes is (a TPU).  Its docstring says that only tokens beyond capacity
are dropped, which is what the port does.  Every kept (expert, slot) is
then written once, so the buffer is the same on every run.

Routing is float32: the router's weight stays float32 and the logits,
softmax and top-k are taken in float32 whatever the activations' dtype.
The top k is a stable descending sort, so equal probabilities go to the
lower expert id first, as ``jax.lax.top_k`` does.  The experts' weights
may be stored in bf16: the JAX package stores them in float32 and casts
them to the activations' dtype at use, which rounds them the same way.
"""

from __future__ import annotations

import functools

import torch
from torch import nn

from . import layers
from .sharding import (Pending, axis_size, constrain, even_splits, local,
                       local_index)


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


class MoE(nn.Module):
    """``router.w`` (d, E) float32; ``wi``, ``wg`` (E, d, f) and ``wo``
    (E, f, d), ``N(0, 1)`` scaled by ``d ** -0.5`` and ``f ** -0.5``;
    ``shared``, a swiglu :class:`layers.MLP` of width ``n_shared_experts
    * d_ff_expert``, where the config has shared experts."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff_expert
        kw = dict(generator=generator, device=device)
        self.router = layers.Linear(d, e, **kw, dtype=torch.float32)
        self.wi = layers.frozen(layers.normal((e, d, f), d ** -0.5, **kw,
                                               dtype=dtype))
        self.wg = layers.frozen(layers.normal((e, d, f), d ** -0.5, **kw,
                                               dtype=dtype))
        self.wo = layers.frozen(layers.normal((e, f, d), f ** -0.5, **kw,
                                               dtype=dtype))
        self.shared = (layers.MLP(d, cfg.n_shared_experts * f, "swiglu", **kw,
                                  dtype=dtype)
                       if cfg.n_shared_experts else None)
        # the assignments beyond capacity in the last call, all groups: a
        # 0-d int64 tensor on the device, set by moe_layer with no sync
        self.n_dropped = None

    def forward(self, cfg, x):
        return moe_layer(self, cfg, x)


def groups(cfg, tokens: int) -> int:
    """Dispatch groups for ``tokens`` tokens: ``cfg.moe_groups``, or 1
    where that does not divide them."""
    g = cfg.moe_groups
    return 1 if tokens % g or tokens // g < 1 else g


def capacity(cfg, group_tokens: int) -> int:
    """Slots an expert has in a group: ``tg * k / E * capacity_factor``,
    truncated, at least 1, rounded up to a multiple of 8 (``moe.py:123``,
    the same Python float expression)."""
    e, k = cfg.n_experts, cfg.top_k
    return _round_up(max(1, int(group_tokens * k / e * cfg.capacity_factor)),
                     8)


def route(p: MoE, cfg, xt: torch.Tensor):
    """Router of the tokens xt (G, Tg, D) -> (probs (G, Tg, E) float32,
    topw (G, Tg, k) renormalised, tope (G, Tg, k) expert ids)."""
    logits = p.router(xt.float())
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    topw = order.values[..., :cfg.top_k]
    tope = order.indices[..., :cfg.top_k]
    return probs, topw / topw.sum(-1, keepdim=True), tope


def _one_hot(ids: torch.Tensor, n: int) -> torch.Tensor:
    """(..., n) int64 one-hot of ``ids`` by comparison: ``F.one_hot``
    checks the ids' range on the host, a synchronisation on the card."""
    return (ids[..., None] == torch.arange(n, device=ids.device)).long()


def positions(cfg, flat_e: torch.Tensor) -> torch.Tensor:
    """Position of each assignment within its expert, in the order of the
    assignments: flat_e (G, N) expert ids -> (G, N)."""
    e = cfg.n_experts
    if cfg.moe_dispatch == "sort":
        n = flat_e.shape[1]
        order = torch.argsort(flat_e, dim=-1, stable=True)
        sorted_e = flat_e.gather(-1, order)
        counts = torch.zeros(flat_e.shape[0], e, dtype=torch.int64,
                             device=flat_e.device).scatter_add_(
            1, flat_e, torch.ones_like(flat_e))
        starts = counts.cumsum(-1) - counts
        pos_sorted = (torch.arange(n, device=flat_e.device)
                      - starts.gather(-1, sorted_e))
        return torch.empty_like(pos_sorted).scatter_(-1, order, pos_sorted)
    # the one-hot cumsum over the assignments, laid out (G, E, N) so that
    # the scan runs along the contiguous axis (on the card a scan along an
    # outer axis is a serial loop a column); integers, so the same counts
    cums = _one_hot(flat_e, e).transpose(1, 2).contiguous().cumsum(-1)
    return cums.gather(1, flat_e[:, None, :])[:, 0] - 1


def expert_ffn(p: MoE, xb: torch.Tensor) -> torch.Tensor:
    """xb (G, E, C, D) -> (G, E, C, D): each expert's swiglu on its slots,
    the weights cast to xb's dtype.  On a mesh the einsums fold the group
    axis into their products, so a group axis split unevenly (one decode
    group over 16 ranks) is gathered first (``sharding.even_splits``)."""
    dt = xb.dtype
    xb = even_splits(xb)
    h = torch.einsum("gecd,edf->gecf", xb, p.wi.to(dt))
    gate = torch.einsum("gecd,edf->gecf", xb, p.wg.to(dt))
    # the JAX package constrains h per group under vmap, which leaves the
    # group axis as it is: on the batch axes here
    h = constrain(layers.silu(h) * gate, "batch", "experts", "expert_cap",
                  None)
    return torch.einsum("gecf,efd->gecd", even_splits(h), p.wo.to(dt))


def _dispatch(xt, flat_e, pos, keep, e: int, cap: int, k: int):
    """Each kept assignment's token into its (group, expert, slot) of a
    (G, E, C, D) buffer; a dropped one writes nothing."""
    g, tg, d = xt.shape
    # flat slot of each assignment in the (G, E, C) buffer; a dropped one
    # goes to one spare row past the end, which is cut off unread
    base = (torch.arange(g, device=xt.device)[:, None] * e + flat_e) * cap
    spare = g * e * cap
    slot = torch.where(keep, base + pos, spare)
    tok = torch.arange(tg * k, device=xt.device) // k
    buf = xt.new_zeros(spare + 1, d)
    buf.index_copy_(0, slot.reshape(-1), xt[:, tok].reshape(g * tg * k, d))
    return buf[:spare].view(g, e, cap, d)


def _combine(yb, flat_e, pos, keep, topw, k: int, first: int = 0):
    """Each token's outputs from the slots of its kept assignments, by
    their weights, summed over its k assignments: (G, Tg, D).  ``yb`` holds
    the experts ``first`` ... ``first + yb.shape[1] - 1``; an assignment to
    another expert, or a dropped one, adds 0."""
    g, n_e, cap, d = yb.shape
    e = flat_e - first
    mine = keep & (e >= 0) & (e < n_e)
    base = (torch.arange(g, device=yb.device)[:, None] * n_e
            + e.clamp(0, n_e - 1)) * cap
    w = torch.where(mine, topw.reshape(flat_e.shape), 0.0).to(yb.dtype)
    y_tok = yb.reshape(g * n_e * cap, d)[torch.where(mine, base + pos,
                                                     base)]
    return (y_tok * w[..., None]).reshape(g, -1, k, d).sum(dim=2)


def moe_layer(p: MoE, cfg, x: torch.Tensor):
    """x (B, S, D) -> (out (B, S, D) in x's dtype, aux loss, 0-d float32).

    Tokens are dispatched within :func:`groups` groups; capacity is per
    group.  The aux loss is Switch's load balance, ``router_aux_weight *
    E * sum(density * mean_prob)`` over all groups.  The count of dropped
    assignments is left in ``p.n_dropped``.
    """
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = groups(cfg, t)
    tg = t // g
    xt = constrain(x.reshape(g, tg, d), "batch", None, None)

    probs, topw, tope = route(p, cfg, xt)
    density = _one_hot(tope[..., 0], e).float().mean(dim=(0, 1))
    aux = cfg.router_aux_weight * e * torch.sum(density
                                                * probs.mean(dim=(0, 1)))

    cap = capacity(cfg, tg)
    flat_e = tope.reshape(g, tg * k)
    rows, cells = ("batch", None), ("batch", None, None, None)
    pos = local(functools.partial(positions, cfg), rows, rows)(flat_e)
    keep = pos < cap
    p.n_dropped = (~keep).sum()
    buf = local(functools.partial(_dispatch, e=e, cap=cap, k=k), cells,
                ("batch", None, None), rows, rows, rows)(xt, flat_e, pos,
                                                         keep)
    buf = constrain(buf, "batch", "experts", "expert_cap", None)
    yb = constrain(expert_ffn(p, buf), "batch", "experts", "expert_cap",
                   None)
    out = _combine_local(cfg, yb, flat_e, pos, keep, topw)
    if p.shared is not None:
        out = out + p.shared(xt)
    return out.reshape(b, s, d), aux


def _combine_local(cfg, yb, flat_e, pos, keep, topw):
    """:func:`_combine` on each rank's groups and experts: with the
    experts split over 'model', each rank adds the outputs of its own
    experts, and the token's sum is pending over 'model' (the block's
    constraint all-reduces it with the shared experts' partial products),
    as XLA partitions the JAX gather from expert-sharded slots.  Without a
    mesh, :func:`_combine` of every expert."""
    k = cfg.top_k
    split = cfg.n_experts % axis_size("experts") == 0
    experts = "experts" if split else None

    def body(yb, flat_e, pos, keep, topw):
        first = local_index("experts") * yb.shape[1] if split else 0
        return _combine(yb, flat_e, pos, keep, topw, k, first)
    rows, out = ("batch", None), ("batch", None, None)
    # each rank weights the outputs of its own experts: its gradient of
    # the weights is its part of a sum over 'model'
    return local(body, Pending(out, ("experts",)) if split else out,
                 ("batch", experts, None, None), rows, rows, rows, out,
                 partial_grads={4: ("experts",)} if split else None)(
                     yb, flat_e, pos, keep, topw)
