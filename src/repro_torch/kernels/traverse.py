"""Wrappers of the CUDA forest-traversal kernels (``csrc/traverse.cu``).

Both replace ``repro/kernels/traverse.py::traverse_chunk_pallas``:

* :func:`traverse_chunk_cuda`, the per-tree form, the counterpart of
  ``ops.traverse_chunk``: leaf values (n, C) of a chunk of C trees;
* :func:`forest_sum_cuda`, the forest-sum form, the serving path:
  ``base + scale * sum`` over the whole stacked forest, the leaf values
  added in tree order, in one launch.

The kernels take CUDA tensors only: these wrappers check device, dtypes,
shapes and contiguity, raise on anything the kernels do not take, and
never fall back to the plain versions (``ref.traverse_chunk_ref``,
``ref.forest_sum_ref``).  The CPU path is chosen by ``ops`` from the
tensor's device.

``launches`` counts the per-tree kernel's launches of this process,
``forest_launches`` the forest-sum kernel's; a run reads them to show
that its traversal went through the kernels.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
forest_launches = 0

# the deepest forest the forest-sum kernel takes: two stages of one tree
# fill a block's shared memory (kMaxSumDepth in the source)
MAX_FOREST_DEPTH = 13

_fns: dict = {}


def _kernel(name: str, dtype: torch.dtype):
    if not _fns:
        lib = _build.library("traverse")
        for dt, suffix in ((torch.float32, "f32"), (torch.int32, "i32")):
            fn = getattr(lib, f"traverse_{suffix}")
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns["chunk", dt] = fn
            fn = getattr(lib, f"forest_sum_{suffix}")
            fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int64]
                           + [ctypes.c_int] * 3 + [ctypes.c_float] * 2
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns["forest", dt] = fn
    return _fns[name, dtype]


def _check(caller: str, values: torch.Tensor, feature: torch.Tensor,
           cmp: torch.Tensor, leaf: torch.Tensor, max_depth: int) -> None:
    """Raises on what the kernels do not take: tensors off the CUDA
    device of ``values``, not contiguous, of other dtypes, or of shapes
    that do not fit ``max_depth``."""
    tensors = {"values": values, "feature": feature, "cmp": cmp,
               "leaf": leaf}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != values.device:
            raise ValueError(
                f"{caller}: {name} is on {t.device}; every tensor must be "
                f"on the CUDA device of values ({values.device})")
        if not t.is_contiguous():
            raise ValueError(f"{caller}: {name} is not contiguous")
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"{caller}: values must be float32 or int32, got "
                        f"{values.dtype}")
    if cmp.dtype != values.dtype:
        raise TypeError(f"{caller}: cmp dtype {cmp.dtype} does not match "
                        f"values dtype {values.dtype}")
    if feature.dtype != torch.int32 or leaf.dtype != torch.float32:
        raise TypeError(f"{caller}: feature must be int32 and leaf float32, "
                        f"got {feature.dtype} / {leaf.dtype}")
    if values.ndim != 2 or feature.ndim != 2:
        raise ValueError(f"{caller}: values and feature must be 2-D")
    C = feature.shape[0]
    n_inner = 2 ** max_depth - 1 if max_depth >= 0 else -1
    if (max_depth < 0 or feature.shape != (C, n_inner)
            or cmp.shape != (C, n_inner) or leaf.shape != (C, n_inner + 1)):
        raise ValueError(
            f"{caller}: shapes feature {tuple(feature.shape)}, cmp "
            f"{tuple(cmp.shape)}, leaf {tuple(leaf.shape)} do not fit "
            f"max_depth={max_depth}")
    if values.shape[1] == 0 and max_depth > 0:
        raise ValueError(f"{caller}: values has no features")


def _launch(fn, *args) -> None:
    with torch.cuda.device(args[0].device):
        stream = torch.cuda.current_stream(args[0].device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a
                   for a in args), stream)
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: cudaError_t {err}")


def traverse_chunk_cuda(values: torch.Tensor, feature: torch.Tensor,
                        cmp: torch.Tensor, leaf: torch.Tensor, *,
                        max_depth: int) -> torch.Tensor:
    """Per-tree leaf values of a stacked tree chunk in one launch.

    Same arguments and result as :func:`repro_torch.kernels.ref.
    traverse_chunk_ref`, bit for bit: values (n, f) float32 with float32
    ``cmp``, or int32 bin ids with int32 ``cmp``; feature (C, 2^d - 1)
    int32; leaf (C, 2^d) float32; all contiguous on one CUDA device.
    A depth-0 forest and an empty batch return without a launch.
    """
    global launches
    _check("traverse_chunk_cuda", values, feature, cmp, leaf, max_depth)
    n, f = values.shape
    C = feature.shape[0]
    if n * C >= 2 ** 31 or max_depth > 30:
        raise ValueError(f"traverse_chunk_cuda: n*C = {n * C} rows x trees "
                         f"or depth {max_depth} is beyond the kernel's range")
    if n == 0 or max_depth == 0:
        # depth-0 forest: every row lands in the single leaf
        return leaf[:, 0].expand(n, C).contiguous()

    out = torch.empty((n, C), dtype=torch.float32, device=values.device)
    _launch(_kernel("chunk", values.dtype), values, feature, cmp, leaf, out,
            n, f, C, max_depth)
    launches += 1
    return out


def forest_sum_cuda(values: torch.Tensor, feature: torch.Tensor,
                    cmp: torch.Tensor, leaf: torch.Tensor, *, max_depth: int,
                    base: float = 0.0, scale: float = 1.0) -> torch.Tensor:
    """``base + scale * sum`` of every tree's leaf value per row, in one
    launch.

    Same arguments and result as :func:`repro_torch.kernels.ref.
    forest_sum_ref`, bit for bit: the whole stacked forest, feature (T,
    2^d - 1) int32, cmp (T, 2^d - 1) of the values' dtype (raw float32 or
    int32 bin ids), leaf (T, 2^d) float32, all contiguous on one CUDA
    device; the leaf values are added in tree order onto +0.0, then
    scaled and shifted as two float32 roundings (``base`` and ``scale``
    are rounded to float32 first, as PyTorch's float32 arithmetic rounds
    a Python number).  Returns (n,) float32; an empty batch returns
    without a launch.  Forests deeper than ``MAX_FOREST_DEPTH`` raise.
    """
    global forest_launches
    _check("forest_sum_cuda", values, feature, cmp, leaf, max_depth)
    n, f = values.shape
    if max_depth > MAX_FOREST_DEPTH:
        raise ValueError(f"forest_sum_cuda: depth {max_depth} is beyond the "
                         f"kernel's {MAX_FOREST_DEPTH} (its shared memory)")
    out = torch.empty((n,), dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    _launch(_kernel("forest", values.dtype), values, feature, cmp, leaf, out,
            n, f, feature.shape[0], max_depth, float(base), float(scale))
    forest_launches += 1
    return out
