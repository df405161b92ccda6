"""Wrapper of the CUDA forest-traversal kernel (``csrc/traverse.cu``).

Replaces ``repro/kernels/traverse.py::traverse_chunk_pallas``.  The
kernel takes CUDA tensors only: this wrapper checks device, dtypes,
shapes and contiguity, raises on anything the kernel does not take, and
never falls back to the plain version (``ref.traverse_chunk_ref``).  The
CPU path is chosen by ``ops.traverse_chunk`` from the tensor's device.

``launches`` counts the kernel launches of this process; a run reads it
to show that its traversal went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

_fns: dict = {}


def _kernel(dtype: torch.dtype):
    if not _fns:
        lib = _build.library("traverse")
        for dt, fn in ((torch.float32, lib.traverse_f32),
                       (torch.int32, lib.traverse_i32)):
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
                ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _fns[dt] = fn
    return _fns[dtype]


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
    tensors = {"values": values, "feature": feature, "cmp": cmp,
               "leaf": leaf}
    for name, t in tensors.items():
        if t.device.type != "cuda" or t.device != values.device:
            raise ValueError(
                f"traverse_chunk_cuda: {name} is on {t.device}; every "
                f"tensor must be on the CUDA device of values "
                f"({values.device})")
        if not t.is_contiguous():
            raise ValueError(f"traverse_chunk_cuda: {name} is not contiguous")
    if values.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"traverse_chunk_cuda: values must be float32 or "
                        f"int32, got {values.dtype}")
    if cmp.dtype != values.dtype:
        raise TypeError(f"traverse_chunk_cuda: cmp dtype {cmp.dtype} does "
                        f"not match values dtype {values.dtype}")
    if feature.dtype != torch.int32 or leaf.dtype != torch.float32:
        raise TypeError("traverse_chunk_cuda: feature must be int32 and "
                        f"leaf float32, got {feature.dtype} / {leaf.dtype}")
    if values.ndim != 2 or feature.ndim != 2:
        raise ValueError("traverse_chunk_cuda: values and feature must be 2-D")
    n, f = values.shape
    C = feature.shape[0]
    n_inner = 2 ** max_depth - 1
    if (max_depth < 0 or feature.shape != (C, n_inner)
            or cmp.shape != (C, n_inner) or leaf.shape != (C, n_inner + 1)):
        raise ValueError(
            f"traverse_chunk_cuda: shapes feature {tuple(feature.shape)}, "
            f"cmp {tuple(cmp.shape)}, leaf {tuple(leaf.shape)} do not fit "
            f"max_depth={max_depth}")
    if f == 0 and max_depth > 0:
        raise ValueError("traverse_chunk_cuda: values has no features")
    if n * C >= 2 ** 31 or max_depth > 30:
        raise ValueError(f"traverse_chunk_cuda: n*C = {n * C} rows x trees "
                         f"or depth {max_depth} is beyond the kernel's range")
    if n == 0 or max_depth == 0:
        # depth-0 forest: every row lands in the single leaf
        return leaf[:, 0].expand(n, C).contiguous()

    out = torch.empty((n, C), dtype=torch.float32, device=values.device)
    stream = torch.cuda.current_stream(values.device).cuda_stream
    with torch.cuda.device(values.device):
        err = _kernel(values.dtype)(
            values.data_ptr(), feature.data_ptr(), cmp.data_ptr(),
            leaf.data_ptr(), out.data_ptr(), n, f, C, max_depth, stream)
    if err != 0:
        raise RuntimeError(f"traverse kernel launch failed: cudaError_t {err}")
    launches += 1
    return out
