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

from . import ref, traverse

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
