"""Front end of the port's kernels: backend resolution and entry points.

Library code calls the kernels through these functions only.  The
backend is ``auto | cuda | ref``, and ``auto`` resolves by the device of
the tensor the call is given: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain PyTorch version in :mod:`ref`.  Asking
for ``cuda`` with a CPU tensor, or ``ref`` with a CUDA tensor, raises;
nothing falls back from one to the other.

The JAX package's backend names (``pallas``, ``interpret``, ``packed``)
may arrive in a checkpoint's config; :func:`backend_name` maps them, and
is the only place that does.
"""

from __future__ import annotations

import dataclasses

import torch

from . import flash_attention as flash_kernel, hist, ref, \
    split_gain as split_gain_kernel, traverse

BACKENDS = ("auto", "cuda", "ref")
_JAX_BACKENDS = {"pallas": "cuda", "interpret": "ref", "packed": "ref"}


def backend_name(backend: str) -> str:
    """The port's name for ``backend``, which may be a JAX package name."""
    backend = _JAX_BACKENDS.get(backend, backend)
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}")
    return backend


def resolve(backend: str, device: torch.device) -> str:
    """Pin ``backend`` to ``cuda`` or ``ref`` for tensors on ``device``."""
    backend = backend_name(backend)
    on_cuda = torch.device(device).type == "cuda"
    if backend == "auto":
        return "cuda" if on_cuda else "ref"
    if backend == "cuda" and not on_cuda:
        raise ValueError(f"backend 'cuda' needs CUDA tensors, got {device}")
    if backend == "ref" and on_cuda:
        raise ValueError("backend 'ref' runs on CPU tensors; a CUDA tensor "
                         "goes to the CUDA kernel")
    return backend


@dataclasses.dataclass(frozen=True)
class HistSpec:
    """Static description of a histogram workload.

    Attributes:
      n_nodes: frontier nodes per level (the widest level this spec
        serves; shallower levels leave high node ids empty).
      nbins: bins per feature (``n_candidates + 1``).
      n_levels: node-id assignments batched per :func:`hist_levels` call.
        A tree builder uses ``n_levels = max_depth`` as its fit-wide spec
        and derives the per-call view with :meth:`with_levels`.
      backend: 'auto' | 'cuda' | 'ref', or a JAX package name, which is
        mapped by :func:`backend_name`.
      acc_dtype: accumulator dtype; only 'float32', which the kernels
        hard-code.  Kept so that a JAX package config maps field for
        field.
      subtract: histogram-subtraction policy.  ``True`` switches
        :func:`hist_levels` to CHILD MODE: ``node_per_level`` carries
        child frontier ids in ``[0, 2 * n_nodes)``, only rows routed LEFT
        (even id) add, keyed by the parent id ``child >> 1``, into
        ``n_nodes`` PARENT buckets; the grower reconstructs each right
        child as ``parent - left``.
    """
    n_nodes: int
    nbins: int
    n_levels: int = 1
    backend: str = "auto"
    acc_dtype: str = "float32"
    subtract: bool = False

    def __post_init__(self):
        if self.n_nodes < 1:
            raise ValueError(f"n_nodes must be >= 1, got {self.n_nodes}")
        if self.nbins < 1:
            raise ValueError(f"nbins must be >= 1, got {self.nbins}")
        if self.n_levels < 1:
            raise ValueError(f"n_levels must be >= 1, got {self.n_levels}")
        if self.acc_dtype != "float32":
            raise ValueError(f"acc_dtype {self.acc_dtype!r} unsupported: "
                             "only 'float32'")
        object.__setattr__(self, "backend", backend_name(self.backend))

    def with_levels(self, n_levels: int) -> "HistSpec":
        """Same spec serving a different number of batched levels."""
        return dataclasses.replace(self, n_levels=n_levels)

    def child_view(self) -> "HistSpec":
        """The half-width parent-keyed panel a subtraction grower adds
        into: ``n_nodes`` halved (at least 1), subtract mode on."""
        return dataclasses.replace(self, n_nodes=max(self.n_nodes // 2, 1),
                                   subtract=True)


def hist_levels(bins: torch.Tensor, node_per_level: torch.Tensor,
                gh: torch.Tensor, spec: HistSpec):
    """Level-batched gradient/hessian histogram.

    Args:
      bins: (n, f) int32 bin ids in [0, spec.nbins).
      node_per_level: (spec.n_levels, n) int32 node ids per level;
        negative = row masked out at that level.  Direct mode: ids in
        [0, spec.n_nodes).  Child mode (``spec.subtract``): CHILD ids in
        [0, 2 * spec.n_nodes), of which only the even ones add.
      gh: (n, 2) float32 grad/hess panel.

    Returns:
      (spec.n_levels, spec.n_nodes, f, nbins, 2) float32: on the CPU bit
      for bit the JAX package's ``hist_levels_ref`` /
      ``hist_levels_left_ref``; on the card one kernel launch that sums
      in fixed point, bit for bit ``ref.hist_levels_fixed`` (the same
      bits on every run) and within ``ref.hist_rounding_bound(...,
      quantum=ref.hist_quanta(gh))`` of the CPU's.  Child mode returns
      it with the rows of each bucket, (spec.n_levels, spec.n_nodes, f,
      nbins) int32, exact on both backends: ``(panel, counts)``.
    """
    if node_per_level.ndim != 2 or node_per_level.shape[0] != spec.n_levels:
        raise ValueError(
            f"node_per_level must be (n_levels={spec.n_levels}, n), got "
            f"shape {tuple(node_per_level.shape)}")
    kw = dict(n_nodes=spec.n_nodes, nbins=spec.nbins)
    on_card = resolve(spec.backend, bins.device) == "cuda"
    if spec.subtract:
        fn = hist.hist_levels_left_cuda if on_card else ref.hist_levels_left_ref
        return fn(bins, node_per_level, gh, **kw)
    fn = hist.hist_levels_cuda if on_card else ref.hist_levels_ref
    return fn(bins, node_per_level, gh, **kw)


def leaf_sums(node: torch.Tensor, gh: torch.Tensor, n_leaves: int,
              backend: str = "auto") -> torch.Tensor:
    """(n_leaves, 2) float32 grad/hess totals of the rows of each leaf.

    On the CPU (``ref``) an ``index_add_`` in row order, as the JAX
    package's scatter adds: bit for bit its leaf sums.  On the card a
    fixed-point sum (``ref.fixed_point_sums``: an int64 ``index_add_`` of
    the quantised g/h), which gives the same bits in any order of the
    card's atomics, so a fit repeats; it lies within a few float32
    roundings of the CPU's.

    Args:
      node: (n,) leaf id of each row, in [0, n_leaves).
      gh: (n, 2) float32 grad/hess panel.
    """
    if resolve(backend, gh.device) == "cuda":
        return ref.fixed_point_sums(node, gh, n_leaves)
    seg = torch.zeros((n_leaves, 2), dtype=torch.float32, device=gh.device)
    seg.index_add_(0, node.long(), gh.to(torch.float32))
    return seg


def split_gain(hist_arr: torch.Tensor, *, l2: float = 1.0,
               gamma: float = 0.0, min_child_weight: float = 1e-6,
               backend: str = "auto"):
    """Best (gain, bin) per (node, feature) from a histogram.

    Both backends agree bit for bit (see :func:`ref.split_gain_ref`).
    """
    kw = dict(l2=l2, gamma=gamma, min_child_weight=min_child_weight)
    if resolve(backend, hist_arr.device) == "cuda":
        return split_gain_kernel.split_gain_cuda(hist_arr, **kw)
    return ref.split_gain_ref(hist_arr, **kw)


@dataclasses.dataclass(frozen=True)
class TraverseSpec:
    """Static description of a batched forest-traversal workload.

    Attributes:
      tree_chunk: trees advanced together per level-synchronous chunk,
        one kernel launch each.  Forests are padded with passthrough
        zero-leaf trees up to a chunk multiple.
      binned: traverse on int32 bin ids (``bin <= split_bin``) instead of
        raw float32 thresholds (``x <= threshold``).  NaN rows bin to the
        LAST bin, while raw NaN compares False and routes RIGHT.
      backend: 'auto' | 'cuda' | 'ref', or a JAX package name, which is
        mapped by :func:`backend_name`.
    """
    tree_chunk: int = 25
    binned: bool = False
    backend: str = "auto"

    def __post_init__(self):
        if self.tree_chunk < 1:
            raise ValueError(
                f"tree_chunk must be >= 1, got {self.tree_chunk}")
        object.__setattr__(self, "backend", backend_name(self.backend))


def traverse_chunk(values: torch.Tensor, feature: torch.Tensor,
                   cmp: torch.Tensor, leaf: torch.Tensor,
                   spec: TraverseSpec, *, max_depth: int) -> torch.Tensor:
    """Level-synchronous descent of one chunk of stacked trees.

    Args:
      values: (n, f) raw float32 features, or int32 bin ids when
        ``spec.binned``.
      feature: (C, 2^max_depth - 1) int32 split features; -1 =
        passthrough.
      cmp: (C, 2^max_depth - 1) float32 thresholds (raw) or int32 split
        bins (binned).
      leaf: (C, 2^max_depth) float32 leaf values.

    Returns:
      (n, C) float32 PER-TREE leaf values; the caller sums them in tree
      order.  Both backends agree bit for bit.
    """
    if resolve(spec.backend, values.device) == "cuda":
        return traverse.traverse_chunk_cuda(values, feature, cmp, leaf,
                                            max_depth=max_depth)
    return ref.traverse_chunk_ref(values, feature, cmp, leaf,
                                  max_depth=max_depth)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    backend: str = "auto",
                    ragged: bool = False) -> torch.Tensor:
    """Blockwise attention with GQA and an optional sliding window.

    q (batch, q_heads, s, d), k and v (batch, kv_heads, s, d).  A CUDA
    tensor goes to a hand-written kernel (one launch), a CPU tensor to
    ``ref.attention_ref``.  In float32 the two agree within float32
    rounding.  In bf16 the card's kernel rounds P to bf16 before its
    product with V, so the two agree within ``ref.
    attention_rounding_bound`` (twice ``2^-9`` times the attention of
    ``|v|``) plus one bf16 rounding of the output.  A causal or window mask
    over queries and keys of different lengths raises on both (see
    ``ref.check_attention_lengths``).

    The kernel takes lengths that are multiples of 128, as the JAX kernel
    does.  With ``ragged`` (the blockwise path of ``xla_chunked``, which
    in the JAX package takes any length) a causal call of another length
    runs the kernel on inputs padded to the next multiple
    (:func:`pad_ragged`); a ragged call with no mask raises on the card.
    """
    if resolve(backend, q.device) == "cuda":
        kernel = flash_kernel.flash_attention_cuda
        if ragged:
            return pad_ragged(kernel, q, k, v, causal=causal, window=window)
        return kernel(q, k, v, causal=causal, window=window)
    return ref.attention_ref(q, k, v, causal=causal, window=window)


def pad_ragged(fn, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
               causal: bool, window: int) -> torch.Tensor:
    """``fn(q, k, v, causal=, window=)`` at any causal length, through
    lengths that are multiples of the kernel's 128
    (``flash_attention.SEQ_MULTIPLE``).

    Lengths that are multiples already go to ``fn`` as they are.
    Otherwise q, k and v are padded with zeros at the tail of the sequence
    to the next multiple, and the output is sliced back.  That is exact
    under a causal mask over equal lengths: a padded key comes after every
    real query, so the mask (and a window with it) hides it, and the
    padded query rows are thrown away.  With no mask the padded keys
    would be attended to, so a ragged length raises: the kernel would
    need a bound on the key length, which it does not take.
    """
    multiple = flash_kernel.SEQ_MULTIPLE
    sq, sk = q.shape[2], k.shape[2]
    if sq % multiple == 0 and sk % multiple == 0:
        return fn(q, k, v, causal=causal, window=window)
    if not causal:
        raise ValueError(
            f"attention with no mask over ragged lengths (sq={sq}, sk={sk}) "
            f"is not built on the card: its kernel takes multiples of "
            f"{multiple} and would need a bound on the key length")
    ref.check_attention_lengths(sq, sk, causal=causal, window=window)
    pad = -sq % multiple
    padded = [torch.nn.functional.pad(t, (0, 0, 0, pad)) for t in (q, k, v)]
    return fn(*padded, causal=causal, window=window)[:, :, :sq]
