"""State-space and recurrent blocks: Mamba2 (SSD), mLSTM, sLSTM.

A port of the JAX package's ``models/ssm.py``.  Mamba2 and mLSTM share
one core, *chunked decay attention*:

    S_t = exp(ld_t) * S_{t-1} + k_t v_t^T          (state (N, P) a head)
    y_t = q_t @ S_t

computed a chunk at a time (Mamba2's SSD block decomposition): a masked
quadratic part inside the chunk plus a scan over chunks that carries S.

  Mamba2:  q = C, k = B, v = dt * x, ld = a * dt  (a = -exp(A_log) < 0)
  mLSTM:   q = q / sqrt(dk), k = i_t * k_t, v = [v, 1], ld =
           log_sigmoid(f_logit); the column of ones carries the
           normalizer n_t in the same state, y = num / max(|den|, 1)

sLSTM is sequential (scalar gates with recurrent feedback of h): a Python
loop over time with the exp-gate stabilizer m_t.  None of the three has a
kernel, in the JAX package or here: they are plain tensor code.

The numerics are the JAX package's: ``A_log``, ``D``, ``dt_bias`` and
sLSTM's ``r`` are float32 parameters, the projections keep the storage
dtype (bf16) and are cast to the activations' dtype at use, states and
every accumulation are float32, and each ``.astype`` of the JAX code is a
rounding here too (``v = xh * dt`` in bf16, ``y + D * xh`` in bf16).
``cfg.ssm_compute_dtype == "bf16"`` rounds the operands of the chunk's
products to bf16, which are then multiplied and summed in float32 (JAX's
``preferred_element_type=float32``).

One departure: inside a chunk the JAX package computes ``exp(cum_i -
cum_j)`` for every (i, j) and masks the product after it.  Above the
diagonal the exponent is positive, and where the log-decays of a chunk
sum below about -88 it overflows float32 to inf, and inf * 0 is NaN (at
xlstm-125m's full width the first 256-token chunk reaches -216, so the
JAX mLSTM prefill is NaN there).  The port masks the exponent before the
``exp``, at -inf; inside the band the values are the JAX package's own.
"""

from __future__ import annotations

import torch
from torch import nn

from . import layers
from .sharding import distribute, flatten, local, unflatten

NEG_INIT = -1e30        # sLSTM's stabilizer m before the first token


def _rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``t`` rounded to ``dtype`` and held in float32: a product of two
    such tensors is JAX's product in ``dtype`` with a float32 result."""
    return t.to(dtype).float()


def _compute_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.ssm_compute_dtype == "bf16" \
        else torch.float32


# ---------------------------------------------------------------------------
# shared core: chunked decay attention
# ---------------------------------------------------------------------------

def chunked_decay_attention(q, k, v, logdecay, chunk: int, state=None,
                            dtype: torch.dtype = torch.float32):
    """Chunk-parallel linear attention with a decay at every step.

    Args:
      q, k: (B, S, G, N), G head groups (Mamba2's B and C pass G = 1 and
        are never broadcast over the heads; mLSTM passes G = H).
      v: (B, S, H, P); logdecay: (B, S, H), <= 0; H % G == 0.
      chunk: the chunk length, S % chunk == 0.
      state: the initial state (B, H, N, P), or None for zeros.
      dtype: the dtype the products' operands are rounded to.

    Returns y (B, S, H, P) and the final state (B, H, N, P), float32.
    """
    b, s, g, n = q.shape
    h, p = v.shape[2], v.shape[3]
    if s % chunk or h % g:
        raise ValueError(f"{s} tokens in chunks of {chunk}, {h} heads in "
                         f"{g} groups: both must divide")
    hg, nc = h // g, s // chunk
    qf = _rounded(q, dtype).reshape(b, nc, chunk, g, n)
    kf = _rounded(k, dtype).reshape(b, nc, chunk, g, n)
    vf = v.float().reshape(b, nc, chunk, g, hg, p)
    ld = logdecay.float().reshape(b, nc, chunk, g, hg)
    S = (torch.zeros((b, g, hg, n, p), dtype=torch.float32, device=q.device)
         if state is None else state.float().reshape(b, g, hg, n, p))
    idx = torch.arange(chunk, device=q.device)
    tri = idx[:, None] >= idx[None, :]                       # (L, M) lower
    ys = []
    for c in range(nc):
        qc, kc, vc, ldc = qf[:, c], kf[:, c], vf[:, c], ld[:, c]
        cum = ldc.cumsum(1)                                  # (B, L, G, Hg)
        total = cum[:, -1:]
        # the group-shared part of the scores, (q_i . k_j) a group
        sc = torch.einsum("blgn,bmgn->bglm", qc, kc)
        # exp(cum_i - cum_j) a head, the exponent masked before the exp
        cum_h = cum.permute(0, 2, 3, 1)                      # (B, G, Hg, L)
        dec = torch.exp(torch.where(
            tri, cum_h[..., :, None] - cum_h[..., None, :], float("-inf")))
        scores = _rounded(sc[:, :, None] * dec, dtype)       # (B,G,Hg,L,M)
        y_intra = torch.einsum("bghlm,bmghp->blghp", scores,
                               _rounded(vc, dtype))
        # from earlier chunks: exp(cum_i) * (q_i @ S_prev), the exp applied
        # to the output so the group-shared q is never expanded a head
        qs = torch.einsum("blgn,bghnp->blghp", qc, _rounded(S, dtype))
        y_inter = qs * torch.exp(cum)[..., None]
        # the state update: the decay on the v side, k stays shared
        v_dec = vc * torch.exp(total - cum)[..., None]
        S = torch.exp(total)[:, 0, ..., None, None] * S + torch.einsum(
            "bmgn,bmghp->bghnp", kc, _rounded(v_dec, dtype))
        ys.append(y_intra + y_inter)
    y = torch.stack(ys, 1).reshape(b, s, h, p)
    return y, S.reshape(b, h, n, p)


def _decay_local(q, k, v, logdecay, chunk: int, state, dtype):
    """:func:`chunked_decay_attention` on each rank's rows and heads (each
    head's recurrence is its own, so no collective runs inside the chunk
    loop), heads split over 'model' as ``sharding.constrain`` splits them.
    q and k are split with the heads where each head has its own (mLSTM:
    G = H); Mamba2's one group stays whole on every rank, which reads it
    for its own heads, so its gradient is the rank's part of a sum over
    'model'.  Without a mesh, :func:`chunked_decay_attention` itself."""
    own = q.shape[2] == v.shape[2]
    qk = ("batch", None, "heads" if own else None, None)
    cells = ("batch", "heads", None, None)

    def body(q, k, v, logdecay, *state):
        if v.shape[2] == 0:
            # a rank past the last head: nothing to run; its inputs stay in
            # the graph, so that every rank's backward runs the same
            # collectives
            zero = (q.sum() + k.sum() + logdecay.sum()).float() * 0
            b, n, p = v.shape[0], q.shape[3], v.shape[3]
            return (v.float() + zero,
                    v.new_zeros(b, 0, n, p, dtype=torch.float32) + zero)
        return chunked_decay_attention(q, k, v, logdecay, chunk,
                                       state[0] if state else None, dtype)
    given = () if state is None else (distribute(state, *cells),)
    return local(body, [("batch", None, "heads", None), cells], qk, qk,
                 ("batch", None, "heads", None), ("batch", None, "heads"),
                 *[cells] * len(given),
                 partial_grads=None if own else {0: ("heads",),
                                                 1: ("heads",)})(
        q, k, v, logdecay, *given)


def decay_attention_step(q, k, v, logdecay, state):
    """One token of the recurrence (decode): q, k (B, H, N), v (B, H, P),
    logdecay (B, H), state (B, H, N, P) -> (y (B, H, P), the new state),
    float32."""
    state = torch.exp(logdecay.float())[..., None, None] * state \
        + k.float()[..., :, None] * v.float()[..., None, :]
    y = torch.einsum("bhn,bhnp->bhp", q.float(), state)
    return y, state


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_dims(cfg) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.ssm_head_dim


def mamba2_state_shape(cfg, batch: int) -> tuple:
    _, nh = mamba2_dims(cfg)
    return (batch, nh, cfg.ssm_state, cfg.ssm_head_dim)


class Mamba2(nn.Module):
    """``ln``, ``in_proj`` (d -> z, x, B, C, dt), ``out_proj``; ``A_log``
    (zeros: a = -1), ``D`` (ones) and ``dt_bias`` (-2: softplus ~ 0.13),
    float32, one a head."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        d_inner, nh = mamba2_dims(cfg)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln = layers.RMSNorm(cfg.d_model, device=device)
        self.in_proj = layers.Linear(
            cfg.d_model, 2 * d_inner + 2 * cfg.ssm_state + nh, **kw)
        self.out_proj = layers.Linear(d_inner, cfg.d_model, **kw)
        f32 = dict(dtype=torch.float32, device=device)
        self.A_log = layers.frozen(torch.zeros(nh, **f32))
        self.D = layers.frozen(torch.ones(nh, **f32))
        self.dt_bias = layers.frozen(torch.full((nh,), -2.0, **f32))

    def forward(self, cfg, x, state=None):
        return mamba2_layer(self, cfg, x, state)


def _mamba2_project(p: Mamba2, cfg, x):
    d_inner, nh = mamba2_dims(cfg)
    n = cfg.ssm_state
    z, xh, bmat, cmat, dt = p.in_proj(p.ln(x)).split(
        [d_inner, d_inner, n, n, nh], dim=-1)
    dt = layers.softplus(dt.float() + p.dt_bias)             # (B, S, nh)
    return z, xh, bmat, cmat, dt, -torch.exp(p.A_log)


def mamba2_layer(p: Mamba2, cfg, x, state=None):
    """x (B, S, D) -> (y (B, S, D), the final state (B, nh, N, P))."""
    s = x.shape[1]
    _, nh = mamba2_dims(cfg)
    z, xh, bmat, cmat, dt, a = _mamba2_project(p, cfg, x)
    xh = unflatten(xh, nh, cfg.ssm_head_dim)
    v = xh * dt[..., None].to(xh.dtype)
    y, st = _decay_local(
        cmat[:, :, None], bmat[:, :, None], v, a * dt,
        min(cfg.ssm_chunk, s), state, _compute_dtype(cfg))
    y = y.to(x.dtype) + p.D.to(x.dtype)[:, None] * xh
    y = flatten(y) * layers.silu(z)
    return p.out_proj(y), st


def mamba2_step(p: Mamba2, cfg, x, state):
    """Decode: x (B, 1, D), state (B, nh, N, P) -> (y, the new state)."""
    b = x.shape[0]
    d_inner, nh = mamba2_dims(cfg)
    z, xh, bmat, cmat, dt, a = _mamba2_project(p, cfg, x)
    xh = unflatten(xh.reshape(b, -1), nh, cfg.ssm_head_dim)
    shape = (b, nh, cfg.ssm_state)
    dt1 = dt[:, 0]                                           # (B, nh)
    v = xh * dt1[..., None].to(xh.dtype)
    y, state = decay_attention_step(cmat[:, 0, None].expand(shape),
                                    bmat[:, 0, None].expand(shape), v,
                                    a * dt1, state)
    y = y.to(x.dtype) + p.D.to(x.dtype)[:, None] * xh
    y = y.reshape(b, 1, d_inner) * layers.silu(z)
    return p.out_proj(y), state


# ---------------------------------------------------------------------------
# mLSTM (the xLSTM matrix-memory block)
# ---------------------------------------------------------------------------

def mlstm_dims(cfg) -> tuple[int, int]:
    d_inner = cfg.ssm_expand * cfg.d_model
    return d_inner, d_inner // cfg.n_heads


def mlstm_state_shape(cfg, batch: int) -> tuple:
    _, dh = mlstm_dims(cfg)
    return (batch, cfg.n_heads, dh, dh + 1)


class MLSTM(nn.Module):
    """``ln``, ``up`` (d -> [xh, z]), ``wq``/``wk``/``wv``, ``wif`` (the
    input and forget gates a head), ``norm``, ``down``."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        d_inner, _ = mlstm_dims(cfg)
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln = layers.RMSNorm(cfg.d_model, device=device)
        self.up = layers.Linear(cfg.d_model, 2 * d_inner, **kw)
        self.wq = layers.Linear(d_inner, d_inner, **kw)
        self.wk = layers.Linear(d_inner, d_inner, **kw)
        self.wv = layers.Linear(d_inner, d_inner, **kw)
        self.wif = layers.Linear(d_inner, 2 * cfg.n_heads, **kw)
        self.norm = layers.RMSNorm(d_inner, device=device)
        self.down = layers.Linear(d_inner, cfg.d_model, **kw)

    def forward(self, cfg, x, state=None):
        return mlstm_layer(self, cfg, x, state)


def _mlstm_project(p: MLSTM, cfg, x):
    b, s, _ = x.shape
    _, dh = mlstm_dims(cfg)
    h = cfg.n_heads
    xh, z = p.up(p.ln(x)).chunk(2, dim=-1)
    # JAX divides by the Python scalar rounded to the activations' dtype
    scale = torch.tensor(dh ** 0.5, dtype=x.dtype).item()
    q = unflatten(p.wq(xh), h, dh) / scale
    k = unflatten(p.wk(xh), h, dh)
    v = unflatten(p.wv(xh), h, dh)
    ig, fg = p.wif(xh).float().chunk(2, dim=-1)              # (B, S, H)
    i_t = torch.sigmoid(ig)
    return xh, z, q, k * i_t[..., None].to(k.dtype), v, layers.log_sigmoid(fg)


def _with_ones(v):
    """v (..., dh) with a column of ones appended: the normalizer rides
    along as one more value column."""
    return torch.cat([v, torch.ones_like(v[..., :1])], -1)


def _mlstm_out(p: MLSTM, cfg, x, yn, z):
    _, dh = mlstm_dims(cfg)
    num, den = yn[..., :dh], yn[..., dh:]
    y = (num / torch.clamp_min(den.abs(), 1.0)).to(x.dtype)
    y = p.norm(flatten(y)) * layers.silu(z)
    return p.down(y)


def mlstm_layer(p: MLSTM, cfg, x, state=None):
    """x (B, S, D) -> (y (B, S, D), the final state (B, H, dh, dh + 1))."""
    s = x.shape[1]
    _, z, q, k, v, ld = _mlstm_project(p, cfg, x)
    yn, st = _decay_local(q, k, _with_ones(v), ld, min(cfg.ssm_chunk, s),
                          state, _compute_dtype(cfg))
    return _mlstm_out(p, cfg, x, yn, z), st


def mlstm_step(p: MLSTM, cfg, x, state):
    """Decode: x (B, 1, D), state (B, H, dh, dh + 1) -> (y, the new
    state)."""
    _, z, q, k, v, ld = _mlstm_project(p, cfg, x)
    yn, state = decay_attention_step(q[:, 0], k[:, 0], _with_ones(v)[:, 0],
                                     ld[:, 0], state)
    return _mlstm_out(p, cfg, x, yn[:, None], z), state


# ---------------------------------------------------------------------------
# sLSTM (scalar memory, sequential)
# ---------------------------------------------------------------------------

def slstm_init_state(cfg, batch: int, *, device) -> tuple:
    """(c, n, h, m): c, n, h zeros (B, H, dh) and m (B, H) at -1e30, all
    float32, four tensors of their own (decode updates them in place)."""
    h, dh = cfg.n_heads, cfg.d_model // cfg.n_heads
    zeros = [torch.zeros((batch, h, dh), dtype=torch.float32, device=device)
             for _ in range(3)]
    return (*zeros, torch.full((batch, h), NEG_INIT, dtype=torch.float32,
                               device=device))


class SLSTM(nn.Module):
    """``ln``, ``wx`` (d -> the input parts of the gates i, f, z, o),
    ``r`` (H, dh, 4 dh) float32 (the block-diagonal recurrent weights, a
    ``dh ** -0.5`` normal), ``down``."""

    def __init__(self, cfg, *, generator=None, device, dtype):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        dh = d // h
        kw = dict(generator=generator, device=device, dtype=dtype)
        self.ln = layers.RMSNorm(d, device=device)
        self.wx = layers.Linear(d, 4 * d, **kw)
        self.r = layers.frozen(layers.normal(
            (h, dh, 4 * dh), dh ** -0.5, generator=generator, device=device,
            dtype=torch.float32))
        self.down = layers.Linear(d, d, **kw)

    def forward(self, cfg, x, state=None):
        return slstm_layer(self, cfg, x, state)


def slstm_scan(r, gx, state):
    """The sequential part: gx (B, S, H, 4 dh), the gates' input parts;
    r (H, dh, 4 dh); state (c, n, h, m).  Returns (h at every step (B,
    S, H, dh), the final state), float32.  Heads lead inside the loop so
    the recurrent product is one batched matmul a step."""
    c, n, hh, m = (t.float().transpose(0, 1) for t in state)  # (H, B, ...)
    g_in = gx.float().permute(1, 2, 0, 3)                    # (S, H, B, 4dh)
    ys = []
    for g_t in g_in:
        gi, gf, gz, go = (g_t + torch.bmm(hh, r)).chunk(4, dim=-1)
        # scalar gates a head: the mean over dh of the i and f parts
        logi, logf = gi.mean(-1), gf.mean(-1)
        m_new = torch.maximum(logf + m, logi)                # stabilizer
        i_t = torch.exp(logi - m_new)[..., None]
        f_t = torch.exp(logf + m - m_new)[..., None]
        c = f_t * c + i_t * torch.tanh(gz)
        n = f_t * n + i_t
        hh = torch.sigmoid(go) * c / torch.clamp_min(n, 1.0)
        m = m_new
        ys.append(hh)
    y = torch.stack(ys).permute(2, 0, 1, 3)                  # (B, S, H, dh)
    return y, tuple(t.transpose(0, 1) for t in (c, n, hh, m))


def slstm_layer(p: SLSTM, cfg, x, state=None):
    """x (B, S, D) -> (y (B, S, D), the final (c, n, h, m))."""
    b, s, d = x.shape
    h = cfg.n_heads
    if state is None:
        state = slstm_init_state(cfg, b, device=x.device)
    x = p.ln(x)
    gx = unflatten(p.wx(x), h, 4 * (d // h))
    y, state = _scan_local(p.r, gx, state)
    return p.down(flatten(y.to(x.dtype))), state


def _scan_local(r, gx, state):
    """:func:`slstm_scan` on each rank's rows and heads (the heads are
    independent; 'model' splits them, as ``sharding.constrain`` splits an
    uneven count): the token loop runs on local tensors, no collective
    inside it.  Each rank's gradient of ``r`` is its part of a sum over
    the batch.  Without a mesh, :func:`slstm_scan` itself."""
    cells, rows = ("batch", "heads", None), ("batch", "heads")
    state = tuple(distribute(t, *(cells if t.ndim == 3 else rows))
                  for t in state)

    def body(r, gx, *state):
        y, new = slstm_scan(r, gx, state)
        return (y, *new)
    y, *new = local(body, [("batch", None, "heads", None), cells, cells,
                           cells, rows], ("heads", None, None),
                    ("batch", None, "heads", None), cells, cells, cells,
                    rows,
                    partial_grads={0: ("batch",)})(r, gx, *state)
    return y, tuple(new)


def slstm_step(p: SLSTM, cfg, x, state):
    """Decode: x (B, 1, D) -> (y, the new state); the layer over one
    token, as in the JAX package."""
    return slstm_layer(p, cfg, x, state)
