"""Wrapper of the CUDA histogram kernel (``csrc/hist.cu``).

Replaces ``repro/kernels/hist.py``: ``hist_levels_pallas`` (direct
mode), ``hist_levels_left_pallas`` (subtraction child mode) and
``hist_pallas`` (a single-level view, not a kernel of its own).  The
kernel takes CUDA tensors only: these wrappers check device, dtypes,
shapes, contiguity and alignment, raise on anything the kernel does not
take, and never fall back to the plain versions (``ref.hist_levels_ref``
and ``ref.hist_levels_left_ref``).  The CPU path is chosen by
``ops.hist_levels`` from the tensor's device.

The kernel sums in fixed point: its result is bit for bit
``ref.hist_levels_fixed`` on the same inputs, whatever the order of its
atomics, so two launches on the same inputs return the same bits.  It
lies within ``ref.hist_rounding_bound(..., quantum=ref.hist_quanta(gh))``
of the plain version.

``launches`` counts this process's direct-mode launches and
``left_launches`` its child-mode launches; a run reads them to show that
its histograms went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

launches = 0
left_launches = 0

_fns: dict = {}


def _lib():
    if not _fns:
        lib = _build.library("hist")
        fn = lib.hist_levels
        fn.argtypes = ([ctypes.c_void_p] * 7 + [ctypes.c_int64]
                       + [ctypes.c_int] * 5 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        for name in ("hist_panel_bytes", "hist_max_parts"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = ctypes.c_int
        _fns["hist_levels"] = fn
        _fns["panel_bytes"] = lib.hist_panel_bytes()
        _fns["max_parts"] = lib.hist_max_parts()
    return _fns


def _launch(bins: torch.Tensor, node_per_level: torch.Tensor,
            gh: torch.Tensor, *, n_nodes: int, nbins: int, child: bool):
    global launches, left_launches
    name = "hist_levels_left_cuda" if child else "hist_levels_cuda"
    tensors = {"bins": bins, "node_per_level": node_per_level, "gh": gh}
    for key, t in tensors.items():
        if t.device.type != "cuda" or t.device != bins.device:
            raise ValueError(f"{name}: {key} is on {t.device}; every tensor "
                             f"must be on the CUDA device of bins "
                             f"({bins.device})")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} is not contiguous")
    if bins.dtype != torch.int32 or node_per_level.dtype != torch.int32:
        raise TypeError(f"{name}: bins and node_per_level must be int32, got "
                        f"{bins.dtype} / {node_per_level.dtype}")
    if gh.dtype != torch.float32:
        raise TypeError(f"{name}: gh must be float32, got {gh.dtype}")
    if bins.ndim != 2 or node_per_level.ndim != 2:
        raise ValueError(f"{name}: bins and node_per_level must be 2-D")
    n, f = bins.shape
    L = node_per_level.shape[0]
    if node_per_level.shape[1] != n or gh.shape != (n, 2):
        raise ValueError(
            f"{name}: shapes bins {tuple(bins.shape)}, node_per_level "
            f"{tuple(node_per_level.shape)}, gh {tuple(gh.shape)} disagree")
    if n_nodes < 1 or nbins < 1:
        raise ValueError(f"{name}: n_nodes={n_nodes} and nbins={nbins} must "
                         "be >= 1")
    if n >= 2 ** 31:
        raise ValueError(f"{name}: {n} rows; the kernel takes fewer than "
                         "2^31")
    fns = _lib()
    bucket_bytes = 20 if child else 16
    if nbins * bucket_bytes > fns["panel_bytes"]:
        raise ValueError(f"{name}: nbins={nbins} is beyond the kernel's "
                         f"range ({fns['panel_bytes'] // bucket_bytes} bins)")
    if gh.data_ptr() % 8:
        raise ValueError(f"{name}: gh is not 8-byte aligned")
    shape = (L, n_nodes, f, nbins)
    dev = bins.device
    if not (n and f and L):                 # nothing to add: no launch
        out = torch.zeros(shape + (2,), dtype=torch.float32, device=dev)
        cnt = torch.zeros(shape, dtype=torch.int32, device=dev)
        return (out, cnt) if child else out
    # the kernel writes every entry of out and cnt, and zeroes its scratch
    out = torch.empty(shape + (2,), dtype=torch.float32, device=dev)
    cnt = torch.empty(shape, dtype=torch.int32, device=dev) if child else None
    acc = torch.empty(out.shape, dtype=torch.int64, device=dev)
    parts = torch.empty(2 * fns["max_parts"], dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fns["hist_levels"](
            bins.data_ptr(), node_per_level.data_ptr(), gh.data_ptr(),
            out.data_ptr(), acc.data_ptr(), parts.data_ptr(),
            cnt.data_ptr() if child else None, n, f, L, n_nodes, nbins,
            int(child), stream)
    if err != 0:
        raise RuntimeError(f"hist kernel launch failed ({name}, L={L}, "
                           f"n_nodes={n_nodes}, f={f}, nbins={nbins}): "
                           f"cudaError_t {err}")
    if child:
        left_launches += 1
    else:
        launches += 1
    return (out, cnt) if child else out


def hist_levels_cuda(bins: torch.Tensor, node_per_level: torch.Tensor,
                     gh: torch.Tensor, *, n_nodes: int,
                     nbins: int) -> torch.Tensor:
    """Grad/hess sums per (level, node, feature, bin) in one launch.

    Same arguments as :func:`repro_torch.kernels.ref.hist_levels_ref`:
    bins (n, f) int32, node_per_level (L, n) int32 (negative = masked),
    gh (n, 2) float32, all contiguous on one CUDA device.  Returns
    (L, n_nodes, f, nbins, 2) float32, bit for bit
    :func:`repro_torch.kernels.ref.hist_levels_fixed`.
    """
    return _launch(bins, node_per_level, gh, n_nodes=n_nodes, nbins=nbins,
                   child=False)


def hist_levels_left_cuda(bins: torch.Tensor, node_per_level: torch.Tensor,
                          gh: torch.Tensor, *, n_nodes: int,
                          nbins: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Subtraction child mode of :func:`hist_levels_cuda`: only rows with
    an even CHILD id add, into parent bucket ``id >> 1`` of an
    ``n_nodes``-parent panel (:func:`repro_torch.kernels.ref.
    hist_levels_left_ref`); rows routed right read no bin ids.  The same
    launch also counts the rows of each bucket, exactly.  Bit for bit
    ``ref.hist_levels_fixed(..., child=True)``.

    Returns:
      ((L, n_nodes, f, nbins, 2) float32 sums, (L, n_nodes, f, nbins)
      int32 row counts).
    """
    return _launch(bins, node_per_level, gh, n_nodes=n_nodes, nbins=nbins,
                   child=True)


def hist_cuda(bins: torch.Tensor, node: torch.Tensor, gh: torch.Tensor, *,
              n_nodes: int, nbins: int) -> torch.Tensor:
    """(n_nodes, f, nbins, 2): the single-level view of
    :func:`hist_levels_cuda`."""
    return hist_levels_cuda(bins, node[None], gh, n_nodes=n_nodes,
                            nbins=nbins)[0]
