"""Wrapper of the CUDA split-gain kernel (``csrc/split_gain.cu``).

Replaces ``repro/kernels/split_gain.py::split_gain_pallas``.  The kernel
takes CUDA tensors only: this wrapper checks device, dtype, shape,
contiguity and alignment, raises on anything the kernel does not take,
and never falls back to the plain version (``ref.split_gain_ref``).  The
CPU path is chosen by ``ops.split_gain`` from the tensor's device.

``launches`` counts the kernel launches of this process.  ``MAX_BINS``
is the most bins a row may have: a row and its scan levels sit in one
block's shared memory (``kMaxBins`` in the source).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0

MAX_BINS = 8192

_fns: dict = {}


def _kernel():
    if not _fns:
        fn = _build.library("split_gain").split_gain
        fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int64, ctypes.c_int]
                       + [ctypes.c_float] * 3 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        _fns["split_gain"] = fn
    return _fns["split_gain"]


def split_gain_cuda(hist: torch.Tensor, *, l2: float = 1.0,
                    gamma: float = 0.0, min_child_weight: float = 1e-6):
    """Best gain and split bin per (node, feature) in one launch.

    Same arguments and result as :func:`repro_torch.kernels.ref.
    split_gain_ref`, bit for bit: hist (n_nodes, f, nbins, 2) float32,
    contiguous on a CUDA device.  ``l2``, ``gamma`` and
    ``min_child_weight`` are rounded to float32, as the plain version's
    float32 arithmetic rounds them.  Returns gains (n_nodes, f) float32
    and idx (n_nodes, f) int32.
    """
    global launches
    if hist.device.type != "cuda":
        raise ValueError(f"split_gain_cuda: hist is on {hist.device}; it "
                         "must be a CUDA tensor")
    if hist.dtype != torch.float32:
        raise TypeError(f"split_gain_cuda: hist must be float32, got "
                        f"{hist.dtype}")
    if hist.ndim != 4 or hist.shape[-1] != 2:
        raise ValueError(f"split_gain_cuda: hist must be (n_nodes, f, nbins, "
                         f"2), got {tuple(hist.shape)}")
    if not hist.is_contiguous():
        raise ValueError("split_gain_cuda: hist is not contiguous")
    if hist.data_ptr() % 8:
        raise ValueError("split_gain_cuda: hist is not 8-byte aligned")
    n_nodes, f, nbins, _ = hist.shape
    if not 1 <= nbins <= MAX_BINS:
        raise ValueError(f"split_gain_cuda: {nbins} bins; the kernel takes "
                         f"1 to {MAX_BINS}")
    gains = torch.empty((n_nodes, f), dtype=torch.float32, device=hist.device)
    idx = torch.empty((n_nodes, f), dtype=torch.int32, device=hist.device)
    rows = n_nodes * f
    if rows == 0:
        return gains, idx
    stream = torch.cuda.current_stream(hist.device).cuda_stream
    with torch.cuda.device(hist.device):
        err = _kernel()(hist.data_ptr(), gains.data_ptr(), idx.data_ptr(),
                        rows, nbins, float(l2), float(gamma),
                        float(min_child_weight), stream)
    if err != 0:
        raise RuntimeError(f"split_gain kernel launch failed: cudaError_t "
                           f"{err}")
    launches += 1
    return gains, idx
