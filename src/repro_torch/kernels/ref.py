"""Plain PyTorch versions of the port's kernels.

They are the ground truth the CUDA kernels are held against on the card,
and the path a CPU tensor takes.  Each mirrors its counterpart in the
JAX package's ``kernels/ref.py`` index for index, so the tests can hold
the two packages bit for bit.
"""

from __future__ import annotations

import torch

# A "chunk" is C stacked trees in heap SoA layout: feature (C, 2^d - 1),
# cmp (C, 2^d - 1) -- raw thresholds (float32) or split bins (int32) --
# and leaf (C, 2^d).  All C trees advance one depth level per step; the
# result is PER-TREE leaf values (n, C), so the caller controls the order
# in which the ensemble is summed.


def gather_feature(values: torch.Tensor, fidx: torch.Tensor) -> torch.Tensor:
    """``values[row, fidx[row, j]]`` with the JAX package's gather rules.

    Ids below 0 are clipped to 0 (the -1 passthrough reads feature 0); an
    id past the last feature reads what a JAX gather fills out of bounds:
    NaN for floats, the most negative value for signed ints (the largest
    for unsigned).  So a malformed forest routes as in the reference, and
    nothing is read outside the row.
    """
    f = values.shape[1]
    fidx = fidx.long().clamp(min=0)
    xv = torch.gather(values, 1, fidx.clamp(max=f - 1))
    if values.is_floating_point():
        fill = float("nan")
    else:
        info = torch.iinfo(values.dtype)
        fill = info.min if values.dtype.is_signed else info.max
    return torch.where(fidx < f, xv, fill)


def traverse_chunk_ref(values: torch.Tensor, feature: torch.Tensor,
                       cmp: torch.Tensor, leaf: torch.Tensor, *,
                       max_depth: int) -> torch.Tensor:
    """Per-tree leaf values of a stacked tree chunk, level by level.

    The same indexing as the per-tree descent ``tree._descend_raw`` /
    ``tree._descend_binned``: at depth ``d`` the heap index is
    ``2^d - 1 + node``, the passthrough feature -1 is clipped to 0 before
    the value gather (:func:`gather_feature`), and the split rule is
    ``value <= cmp`` (NaN compares False, so raw NaN rows route RIGHT).

    Args:
      values: (n, f) raw float32 features or int32 bin ids; the dtype
        carries the mode.
      feature: (C, 2^max_depth - 1) int32 split features; -1 = passthrough.
      cmp: (C, 2^max_depth - 1) float32 thresholds or int32 split bins.
      leaf: (C, 2^max_depth) float32 leaf values.

    Returns:
      (n, C) float32 per-tree leaf values.
    """
    n = values.shape[0]
    C = feature.shape[0]
    tree = torch.arange(C, device=values.device)          # (C,) broadcasts
    node = torch.zeros((n, C), dtype=torch.long, device=values.device)
    for depth in range(max_depth):
        heap = (2 ** depth - 1) + node                    # (n, C)
        xv = gather_feature(values, feature[tree, heap])
        node = node * 2 + torch.where(xv <= cmp[tree, heap], 0, 1)
    return leaf[tree, node]


# ---------------------------------------------------------------------------
# Histograms.  Bucket (level, node, feature, bin) of the flat panel is
# ((level * n_nodes + node) * f + feature) * nbins + bin; each bucket
# holds a (grad, hess) pair.
# ---------------------------------------------------------------------------

def hist_levels_ref(bins: torch.Tensor, node_per_level: torch.Tensor,
                    gh: torch.Tensor, *, n_nodes: int,
                    nbins: int) -> torch.Tensor:
    """Grad/hess sums per (level, node, feature, bin), by ``index_add_``.

    On the CPU ``index_add_`` adds in source order, so every bucket sums
    its rows in row order, as the JAX package's ``hist_levels_ref``
    scatter does: the two are equal bit for bit.  On a CUDA tensor the
    adds are atomics in no fixed order.

    A row whose node id is negative (masked) or ``>= n_nodes``, or whose
    bin id lies outside ``[0, nbins)``, is dropped for that level or
    feature.  On valid ids this is the JAX result; on invalid ids the
    JAX ``hist_ref`` would alias the row into a neighbouring bucket.

    Args:
      bins: (n, f) integer bin ids.
      node_per_level: (L, n) integer node ids per level.
      gh: (n, 2) float32 grad/hess panel.

    Returns:
      (L, n_nodes, f, nbins, 2) float32.
    """
    L, n = node_per_level.shape
    f = bins.shape[1]
    key, valid = _bucket_keys(bins, node_per_level, n_nodes, nbins)
    vals = gh.to(torch.float32)[None, :, None, :].expand(L, n, f, 2)
    out = torch.zeros((L * n_nodes * f * nbins, 2), dtype=torch.float32,
                      device=bins.device)
    out.index_add_(0, key[valid], vals[valid])
    return out.reshape(L, n_nodes, f, nbins, 2)


def _bucket_keys(bins, node_per_level, n_nodes, nbins):
    """(L, n, f) flat bucket of each (level, row, feature), and whether
    its node and bin ids are in range."""
    L = node_per_level.shape[0]
    f = bins.shape[1]
    dev = bins.device
    node = node_per_level.long()
    b = bins.long()
    fb = torch.arange(f, device=dev)[None, :] * nbins + b          # (n, f)
    key = ((torch.arange(L, device=dev)[:, None] * n_nodes + node)
           [:, :, None] * (f * nbins) + fb[None])                   # (L, n, f)
    valid = (((node >= 0) & (node < n_nodes))[:, :, None]
             & ((b >= 0) & (b < nbins))[None])
    return key, valid


def _parent_ids(node_per_level: torch.Tensor) -> torch.Tensor:
    """Child frontier ids -> the parent bucket a left child adds into;
    -1 (dropped) for a right child or a masked row."""
    node = node_per_level.long()
    return torch.where((node >= 0) & (node % 2 == 0), node // 2, -1)


def hist_levels_left_ref(bins: torch.Tensor, node_per_level: torch.Tensor,
                         gh: torch.Tensor, *, n_nodes: int,
                         nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtraction child mode: only rows routed LEFT add, keyed by parent.

    ``node_per_level`` holds CHILD frontier ids: the left child of
    parent ``p`` is ``2p``, the right ``2p + 1``.  Even ids add into
    bucket ``id >> 1`` of an ``n_nodes``-parent panel; odd and negative
    ids drop out.  The grower derives each right child as
    ``parent - left``, and keeps a right bucket whose count falls to 0
    exactly zero.

    Returns:
      ((L, n_nodes, f, nbins, 2) float32 sums -- bit for bit the JAX
      package's ``hist_levels_left_ref`` --, (L, n_nodes, f, nbins) int32
      rows of each bucket).
    """
    parent = _parent_ids(node_per_level)
    out = hist_levels_ref(bins, parent, gh, n_nodes=n_nodes, nbins=nbins)
    key, valid = _bucket_keys(bins, parent, n_nodes, nbins)
    keys = key[valid]
    cnt = torch.zeros(out[..., 0].numel(), dtype=torch.int32,
                      device=bins.device)
    cnt.index_add_(0, keys, torch.ones_like(keys, dtype=torch.int32))
    return out, cnt.reshape(out.shape[:-1])


def hist_ref(bins: torch.Tensor, node: torch.Tensor, gh: torch.Tensor, *,
             n_nodes: int, nbins: int) -> torch.Tensor:
    """(n_nodes, f, nbins, 2) single-level view of :func:`hist_levels_ref`."""
    return hist_levels_ref(bins, node[None], gh, n_nodes=n_nodes,
                           nbins=nbins)[0]


# ---------------------------------------------------------------------------
# Fixed-point sums: the CUDA histogram kernel's arithmetic (csrc/hist.cu),
# and the card's leaf sums.  Integer adds give the same sum in any order,
# so a sum on the card repeats from run to run.
# ---------------------------------------------------------------------------

FIXED_POINT_BITS = 62     # a bucket's int64 sum stays within 2^62
MAX_SHIFT = 100           # 2^-s stays a normal float32


def _pow2(k: torch.Tensor) -> torch.Tensor:
    """2^k as float32, exactly, for integer k in [-126, 127]."""
    return ((k.to(torch.int32) + 127) << 23).view(torch.float32)


def hist_shifts(gh: torch.Tensor) -> torch.Tensor:
    """(2,) int32: the shift ``s`` of g and of h for a sum over the rows
    of ``gh`` (n, 2), computed where ``gh`` lies, with no host sync.

    With ``2^N >= n`` and ``max|x| < 2^E`` (``E`` = the float32 exponent
    field of max|x| less 126, a zero or subnormal maximum counting as field
    1), ``s = min(62 - N - E, 100)``: each ``x`` becomes the integer
    ``rint(x * 2^s)``, of magnitude at most ``2^(E+s)``, and a sum of at
    most ``n`` of them stays within ``n * 2^(E+s) <= 2^62``.
    """
    n = gh.shape[0]
    log2n = (n - 1).bit_length() if n > 1 else 0
    # |x| as float bits: their order is the float order (NaN, inf last)
    bits = (gh.to(torch.float32).abs().view(torch.int32).amax(0) if n else
            torch.zeros(2, dtype=torch.int32, device=gh.device))
    e = ((bits >> 23) & 0xFF).clamp(min=1) - 126
    return (FIXED_POINT_BITS - log2n - e).clamp(max=MAX_SHIFT).to(torch.int32)


def hist_quanta(gh: torch.Tensor) -> torch.Tensor:
    """(2,) float32: the quantum ``2^-s`` of g and of h (:func:`hist_shifts`)
    -- the spacing of the fixed-point grid a sum over these rows uses."""
    return _pow2(-hist_shifts(gh))


def _to_fixed(gh: torch.Tensor):
    """(q, quantum, finite): ``gh`` (n, 2) as int64 multiples of each
    column's quantum (round to nearest even), the (2,) quanta, and whether
    each column is finite in every row."""
    gh = gh.to(torch.float32)
    s = hist_shifts(gh)
    finite = torch.isfinite(gh).all(0)
    q = torch.round(torch.where(torch.isfinite(gh), gh, 0.0) * _pow2(s))
    return q.to(torch.int64), _pow2(-s), finite


def _from_fixed(total: torch.Tensor, quantum: torch.Tensor,
                finite: torch.Tensor) -> torch.Tensor:
    """int64 sums (..., 2) -> float32: one rounding to float32, times the
    quantum (exact); NaN in a column with a non-finite row."""
    out = total.to(torch.float32) * quantum
    return torch.where(finite, out, float("nan"))


def fixed_point_sums(index: torch.Tensor, gh: torch.Tensor,
                     size: int) -> torch.Tensor:
    """(size, 2) float32: the rows of ``gh`` (n, 2) summed by ``index``
    (n,), in fixed point (:func:`hist_shifts`).  The same in any order of
    adds, on any device.  A non-finite value in a column makes that
    column NaN."""
    q, quantum, finite = _to_fixed(gh)
    total = torch.zeros((size, 2), dtype=torch.int64, device=gh.device)
    total.index_add_(0, index.long(), q)
    return _from_fixed(total, quantum, finite)


def hist_levels_fixed(bins: torch.Tensor, node_per_level: torch.Tensor,
                      gh: torch.Tensor, *, n_nodes: int, nbins: int,
                      child: bool = False):
    """The CUDA kernel's arithmetic in plain PyTorch: its result bit for
    bit, on any device.

    Each column of ``gh`` becomes int64 multiples of its launch-wide
    quantum (:func:`hist_shifts`, from all ``n`` rows); the buckets sum
    them with an int64 ``index_add_``; each sum is rounded once to float32
    and scaled by the quantum.  A non-finite g (or h) in any row makes every
    g (or h) sum NaN.  The buckets and the rows that drop out are those of
    :func:`hist_levels_ref` (direct) or :func:`hist_levels_left_ref`
    (``child``).

    Returns:
      (L, n_nodes, f, nbins, 2) float32; with ``child``, also the
      (L, n_nodes, f, nbins) int32 row counts.
    """
    node = _parent_ids(node_per_level) if child else node_per_level
    L, n = node.shape
    f = bins.shape[1]
    key, valid = _bucket_keys(bins, node, n_nodes, nbins)
    q, quantum, finite = _to_fixed(gh)
    total = torch.zeros((L * n_nodes * f * nbins, 2), dtype=torch.int64,
                        device=bins.device)
    total.index_add_(0, key[valid], q[None, :, None, :].expand(
        L, n, f, 2)[valid])
    out = _from_fixed(total, quantum, finite).reshape(L, n_nodes, f, nbins, 2)
    if not child:
        return out
    keys = key[valid]
    cnt = torch.zeros(L * n_nodes * f * nbins, dtype=torch.int32,
                      device=bins.device)
    cnt.index_add_(0, keys, torch.ones_like(keys, dtype=torch.int32))
    return out, cnt.reshape(out.shape[:-1])


# ---------------------------------------------------------------------------
# Split gain.
# ---------------------------------------------------------------------------

PREFIX_BLOCK = 16


def blocked_prefix(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the last axis, in XLA:CPU's association.

    XLA:CPU lowers ``jnp.cumsum`` over a long axis as a scan of blocks of
    16: a sequential sum within each block, and ``carry + local`` for
    every later block, where ``carry`` is the prefix of the block totals
    up to the previous block, computed the same way one level up.  Up
    to 16 elements that is a plain sequential sum, up to 256 the carry
    is the previous block's last prefix.  ``torch.cumsum`` associates
    otherwise, so this is written out; the split-gain kernel walks the
    bins in the same order.
    """
    n = x.shape[-1]
    if n <= PREFIX_BLOCK:
        out = x.clone()
        for i in range(1, n):
            out[..., i] = out[..., i - 1] + x[..., i]
        return out
    m = -(-n // PREFIX_BLOCK)
    xp = torch.nn.functional.pad(x, (0, m * PREFIX_BLOCK - n))
    local = blocked_prefix(xp.reshape(*x.shape[:-1], m, PREFIX_BLOCK))
    carry = blocked_prefix(local[..., -1])                   # (..., m)
    out = torch.cat([local[..., :1, :],
                     carry[..., :-1, None] + local[..., 1:, :]], dim=-2)
    return out.reshape(*x.shape[:-1], m * PREFIX_BLOCK)[..., :n]


def argmax_nan_first(x: torch.Tensor, dim: int = -1):
    """``(max, argmax)`` along ``dim`` with ``jnp.max``/``jnp.argmax``
    semantics: NaN counts as the maximum and the first NaN wins;
    otherwise the first maximum wins."""
    isnan = torch.isnan(x)
    has_nan = isnan.any(dim)
    clean = torch.where(isnan, float("-inf"), x)
    best = clean.amax(dim)
    idx = clean.argmax(dim)
    first_nan = isnan.to(torch.uint8).argmax(dim)
    return (torch.where(has_nan, float("nan"), best),
            torch.where(has_nan, first_nan, idx))


def _score(g: torch.Tensor, h: torch.Tensor, l2: float) -> torch.Tensor:
    return (g * g) / (h + l2)


def split_gain_ref(hist: torch.Tensor, *, l2: float = 1.0,
                   gamma: float = 0.0, min_child_weight: float = 1e-6):
    """Best gain and split bin per (node, feature), as the JAX package's
    ``split_gain_ref`` computes them, bit for bit on the CPU.

    gain(s) = 0.5 * (GL^2/(HL+l2) + GR^2/(HR+l2) - G^2/(H+l2)) - gamma,
    legal where both sides hold ``min_child_weight`` of hessian and
    ``s < nbins - 1``; the prefix sums use :func:`blocked_prefix`.

    Args:
      hist: (n_nodes, f, nbins, 2) float32.

    Returns:
      gains (n_nodes, f) float32, -inf where no split is legal; idx
      (n_nodes, f) int32, the first best bin (NaN gains win, as in
      ``jnp.argmax``).
    """
    g = hist[..., 0]
    h = hist[..., 1]
    gl = blocked_prefix(g)
    hl = blocked_prefix(h)
    gt = gl[..., -1:]
    ht = hl[..., -1:]
    gr = gt - gl
    hr = ht - hl
    gain = 0.5 * (_score(gl, hl, l2) + _score(gr, hr, l2)
                  - _score(gt, ht, l2)) - gamma
    nbins = gain.shape[-1]
    pos = torch.arange(nbins, device=hist.device)
    ok = (hl >= min_child_weight) & (hr >= min_child_weight) \
        & (pos < nbins - 1)
    gain = torch.where(ok, gain, float("-inf"))
    best, idx = argmax_nan_first(gain, dim=-1)
    return best, idx.to(torch.int32)


def hist_rounding_bound(bins: torch.Tensor, node_per_level: torch.Tensor,
                        gh: torch.Tensor, *, n_nodes: int, nbins: int,
                        child: bool = False, quantum=0) -> torch.Tensor:
    """How far two float32 histograms of the same rows, summed in any two
    orders, may lie apart, bucket by bucket.

    Any order of summing m float32 terms lands within
    ``gamma(m-1) * sum|x|`` of the exact sum, ``gamma(j) = j u / (1 - j u)``
    with ``u = 2^-24`` (Higham, *Accuracy and Stability of Numerical
    Algorithms*, 4.2), so two orders lie within twice that.  A bucket of
    0 or 1 rows has bound 0: one add to zero is exact.

    With a non-zero ``quantum`` (a float, or the (2,) quanta of g and h,
    :func:`hist_quanta`), one of the two is a fixed-point sum
    (:func:`hist_levels_fixed`): each of its m terms is rounded to the
    quantum (at most ``q/2`` each) and its exact sum rounded once to
    float32, so the bound gains ``m q / 2 + u (sum|x| + m q / 2)``.  At
    ``quantum=0`` it is the bound above, unchanged.

    Returns:
      (L, n_nodes, f, nbins, 2) float64, shaped like the histogram.
    """
    node = _parent_ids(node_per_level) if child else node_per_level
    kw = dict(n_nodes=n_nodes, nbins=nbins)
    abs_sum = hist_levels_ref(bins, node, gh.abs(), **kw).double()
    m = hist_levels_ref(bins, node, torch.ones_like(gh), **kw).double()
    gamma = (m - 1).clamp(min=0) * 2.0 ** -24
    bound = 2 * gamma / (1 - gamma) * abs_sum
    if isinstance(quantum, (int, float)) and quantum == 0:
        return bound
    half = m * torch.as_tensor(quantum, dtype=torch.float64,
                               device=bins.device) / 2
    return bound + half + 2.0 ** -24 * (abs_sum + half)


def attention_rounding_bound(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, causal: bool = True,
                             window: int = 0) -> torch.Tensor:
    """How far attention whose P is rounded to bf16 before its product with
    V may lie from the float32 :func:`attention_ref`, element by element.

    The Hopper kernel rounds each float32 ``p_j`` to bf16 (relative error
    at most 2^-9, to nearest even) as the A operand of ``P V`` and keeps
    ``l`` as the sum of the float32 ``p``, so an output element moves by
    at most ``2^-9 sum_j p_j |v_j| / l``: ``2^-9`` times the attention of
    ``|v|``.  The bound is twice that, for margin.

    Returns:
      (batch, q_heads, sq, d) float32, shaped like the output.
    """
    return 2.0 ** -8 * attention_ref(q.float(), k.float(), v.float().abs(),
                                     causal=causal, window=window)


def check_attention_lengths(sq: int, sk: int, *, causal: bool,
                            window: int) -> None:
    """Refuse a mask over queries and keys of different lengths.

    There the JAX package's two attention functions disagree: its kernel
    counts query positions from 0, its oracle ``attention_ref``
    right-aligns them (``qpos = arange(sq) + (sk - sq)``, the cache case).
    The port takes neither side silently.
    """
    if sq != sk and (causal or window > 0):
        raise ValueError(
            f"a causal or window mask needs as many queries as keys, got "
            f"sq={sq}, sk={sk}: the JAX kernel and the JAX oracle place the "
            "queries differently there")


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """Naive float32 attention with GQA and causal / sliding-window masks.

    Mirrors the JAX package's ``attention_ref``: query head ``h`` reads KV
    head ``h // g`` (``g = q_heads // kv_heads``, no repeated K/V), scores
    in float32 divided by ``d ** 0.5``, masked keys at -inf, a row with no
    kept key gives 0, the output in q's dtype.  Raises where queries and
    keys differ in length under a mask (:func:`check_attention_lengths`).

    Args:
      q: (batch, q_heads, sq, d).
      k, v: (batch, kv_heads, sk, d).
    """
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    check_attention_lengths(sq, sk, causal=causal, window=window)
    if hq % hkv:
        raise ValueError(f"q_heads {hq} is not a multiple of kv_heads {hkv}")
    g = hq // hkv
    qg = q.float().reshape(b, hkv, g * sq, d)
    s = (qg @ k.float().transpose(-1, -2)).reshape(b, hkv, g, sq, sk)
    s = s / (d ** 0.5)
    qpos = torch.arange(sq, device=q.device)[:, None]
    kpos = torch.arange(sk, device=q.device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    p = torch.softmax(s.masked_fill_(~mask, float("-inf")), dim=-1)
    del s
    p = p.masked_fill_(torch.isnan(p), 0.0)
    out = p.reshape(b, hkv, g * sq, sk) @ v.float()
    return out.reshape(b, hq, sq, d).to(q.dtype)
