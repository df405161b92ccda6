"""Wrapper of the CUDA flash-attention kernels (``csrc/flash_attention.cu``).

Replaces ``repro/kernels/flash_attention.py::flash_attention_pallas``.
The kernels take CUDA tensors only: this wrapper checks device, dtype,
shape, contiguity and alignment, raises on anything they do not take,
and never falls back to the plain version (``ref.attention_ref``).  The
CPU path is chosen by ``ops.flash_attention`` from the tensor's device.
The JAX kernel has no VJP.  The gradient is :func:`flash_attention_bwd_cuda`
(``csrc/flash_attention_bwd.cu``), which ``ops.flash_attention`` wraps
with this kernel in a ``torch.autograd.Function``; both entries here take
detached tensors and refuse an input that requires a gradient.

Two kernels, chosen by :func:`variant` from the dtype alone: every bf16
call runs on the Hopper kernel (``wgmma`` on the tensor cores, TMA, P
rounded to bf16 before its product with V), every float32 call on the
CUDA-core kernel, which keeps P in float32.  A failure of the chosen
kernel raises; no call is retried on the other.

``launches`` counts the kernel launches of this process,
``launches_by_variant`` the same launches by kernel.  ``bwd_launches``
counts the calls of the backward, ``bwd_launches_by_kernel`` their
kernel launches by kernel: each call adds one to each kernel of its
variant (:data:`BWD_KERNELS`) that it launches (:func:`bwd_kernels`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from .ref import check_attention_lengths

HEAD_DIMS = (32, 64, 80, 128)   # the head dims some kernel takes
SEQ_MULTIPLE = 128              # as the JAX kernel asserts; the Hopper
                                # kernel's block of query rows
DTYPES = (torch.float32, torch.bfloat16)

# The dispatch.  bf16 goes to the Hopper kernel at every head dim it
# takes (d = 80 in column chunks of 32, the last one half filled with
# zeros by TMA); float32 to the CUDA-core kernel: a TF32 wgmma keeps 10
# bits of mantissa and would break the float32 contract (2e-4) with the
# JAX package.
WGMMA_HEAD_DIMS = HEAD_DIMS
VARIANTS = ("wgmma_bf16", "cuda_core_f32")

launches = 0
launches_by_variant = dict.fromkeys(VARIANTS, 0)

# The backward, by dtype.  bf16 on the tensor cores (wgmma, TMA, lse from
# the forward): bwd_dq_wgmma (with delta), bwd_dkdv_wgmma, and where a
# group's query heads are split among the dK/dV work items bwd_dkdv_sum,
# which adds the chunks' float32 sums.  float32 on the CUDA cores: bwd_dq
# (with lse, unless given, and delta) then bwd_dkdv.
BWD_VARIANTS = ("bwd_wgmma_bf16", "bwd_cuda_core_f32")
BWD_KERNELS = {"bwd_wgmma_bf16": ("bwd_dq_wgmma", "bwd_dkdv_wgmma",
                                  "bwd_dkdv_sum"),
               "bwd_cuda_core_f32": ("bwd_dq", "bwd_dkdv")}
bwd_launches = 0
bwd_launches_by_kernel = dict.fromkeys(
    [name for names in BWD_KERNELS.values() for name in names], 0)
DKDV_KEYS = 64          # keys a dK/dV work item of the bf16 kernel
ITEMS_PER_SM = 4        # dK/dV work items an SM at least, where they split
H100_SMS = 132

_fns: dict = {}
_bwd_fns: dict = {}


def variant(dtype: torch.dtype, d: int) -> str:
    """The kernel that takes a call of this dtype, at any head dim of
    :data:`HEAD_DIMS`."""
    return "wgmma_bf16" if dtype == torch.bfloat16 else "cuda_core_f32"


def _kernel(name: str):
    """The C entry of a variant: ``flash_attention_wgmma`` (bf16), which
    also takes the lse output (or null) and the kernel's work-item count
    after the output, or ``flash_attention`` (the CUDA-core kernel,
    float32)."""
    if not _fns:
        lib = _build.library("flash_attention")
        for variant_name, entry, pointers in (
                ("wgmma_bf16", "flash_attention_wgmma", 6),
                ("cuda_core_f32", "flash_attention", 4)):
            fn = getattr(lib, entry)
            fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 7
                           + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                              ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fns[variant_name] = fn
    return _fns[name]


def bwd_variant(dtype: torch.dtype) -> str:
    """The backward's kernels for a call of this dtype."""
    return ("bwd_wgmma_bf16" if dtype == torch.bfloat16
            else "bwd_cuda_core_f32")


def dkdv_heads_per_chunk(batch: int, q_heads: int, kv_heads: int, sk: int,
                         sms: int = H100_SMS) -> int:
    """The query heads of a group that one dK/dV work item of the bf16
    backward sums over.

    An item is (batch, kv head, 64-key tile, chunk of the group's query
    heads).  The whole group where that already makes ``ITEMS_PER_SM *
    sms`` items (no split, no scratch); else the group in the fewest
    chunks of about equal size that reach that many.  internvl2-1b's
    training shape (2 x 2 kv heads of 7, 68 key tiles: 272 items whole)
    gets 4 heads a chunk (chunks of 4 and 3, 544 items), glm4-9b's (1 x 2
    of 16, 64 tiles: 128) 3 (six chunks, the last of 1 head: 768 items).
    """
    g = q_heads // kv_heads
    base = batch * kv_heads * (sk // DKDV_KEYS)
    target = ITEMS_PER_SM * sms
    if base >= target:
        return g
    heads = math.ceil(g / min(g, math.ceil(target / base)))
    while heads > 1 and base * math.ceil(g / heads) < target:
        heads -= 1
    return heads


def sm_count(device) -> int:
    """The SM count of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def bwd_kernels(dtype: torch.dtype, batch: int, q_heads: int, kv_heads: int,
                sk: int, sms: int = H100_SMS) -> tuple:
    """The kernels that one backward call of this dtype and shape launches:
    the float32 variant's two; the bf16 variant's dQ and dK/dV kernels,
    and its sum of the chunks where :func:`dkdv_heads_per_chunk` splits a
    group."""
    kernels = BWD_KERNELS[bwd_variant(dtype)]
    if dtype != torch.bfloat16:
        return kernels
    split = dkdv_heads_per_chunk(batch, q_heads, kv_heads, sk, sms) < (
        q_heads // kv_heads)
    return kernels if split else kernels[:2]


def _bwd_kernel(name: str):
    """The C entry of a backward variant."""
    if not _bwd_fns:
        lib = _build.library("flash_attention_bwd")
        fn = lib.flash_attention_bwd_wgmma
        fn.argtypes = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        _bwd_fns["bwd_wgmma_bf16"] = fn
        fn = lib.flash_attention_bwd_f32
        fn.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
                       + [ctypes.c_float] + [ctypes.c_int] * 3
                       + [ctypes.c_void_p])
        _bwd_fns["bwd_cuda_core_f32"] = fn
        for fn in _bwd_fns.values():
            fn.restype = ctypes.c_int
    return _bwd_fns[name]


def _check_tensor(name, t, arg):
    if t.device.type != "cuda":
        raise ValueError(f"{name}: {arg} is on {t.device}; it must be a "
                         "CUDA tensor")
    if t.dtype not in DTYPES:
        raise TypeError(f"{name}: {arg} must be float32 or bfloat16, got "
                        f"{t.dtype}")
    if t.ndim != 4:
        raise ValueError(f"{name}: {arg} must be (batch, heads, seq, d), "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: {arg} is not contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: {arg} is not 16-byte aligned")
    if t.requires_grad:
        raise ValueError(f"{name}: {arg} requires grad; the kernel takes "
                         "detached tensors (ops.flash_attention wraps it "
                         "for autograd)")


def _check(q, k, v, window, kv_len, name="flash_attention_cuda"):
    for t, arg in ((q, "q"), (k, "k"), (v, "v")):
        _check_tensor(name, t, arg)
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"{name}: q, k and v differ in dtype ({q.dtype}, "
                        f"{k.dtype}, {v.dtype})")
    if not (q.device == k.device == v.device):
        raise ValueError(f"{name}: q, k and v lie on different devices")
    b, hq, sq, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"{name}: k {tuple(k.shape)} and v "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    hkv, sk = k.shape[1], k.shape[2]
    if hkv < 1 or hq % hkv:
        raise ValueError(f"{name}: q_heads {hq} is not a multiple of "
                         f"kv_heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {d} not built; the kernel takes "
                         f"{HEAD_DIMS}")
    if sq % SEQ_MULTIPLE or sk % SEQ_MULTIPLE:
        raise ValueError(f"{name}: sequence lengths must be multiples of "
                         f"{SEQ_MULTIPLE}, got sq={sq}, sk={sk}")
    if window < 0:
        raise ValueError(f"{name}: window must be >= 0, got {window}")
    if kv_len is not None and not 1 <= kv_len <= sk:
        raise ValueError(f"{name}: kv_len must lie in [1, sk={sk}], got "
                         f"{kv_len}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: int = 0,
                         kv_len: int | None = None, with_lse: bool = False):
    """Blockwise attention in one launch of the kernel :func:`variant`
    picks.

    Same arguments and result as :func:`repro_torch.kernels.ref.
    attention_ref`: float32 within float32 rounding; bf16 within the
    rounding of P to bf16 (``ref.attention_rounding_bound``) and of the
    output.  q (batch, q_heads, sq, d), k and v (batch, kv_heads, sk, d),
    contiguous on one CUDA device, all float32 or all bfloat16; ``d`` in
    :data:`HEAD_DIMS`; ``sq`` and ``sk`` multiples of 128; ``kv_len`` (1
    to ``sk``, default ``sk``) the keys attended to, the rest padding.
    Returns (batch, q_heads, sq, d) in q's dtype; with ``with_lse`` (bf16
    only: the Hopper kernel's instance that writes it) also (batch,
    q_heads, sq) float32, each row's log-sum-exp of its kept scaled scores
    (``ref.attention_lse``, +inf where a row keeps no key), which
    :func:`flash_attention_bwd_cuda` takes.  The output is the same bits
    either way.
    """
    global launches
    _check(q, k, v, window, kv_len)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kv_len = sk if kv_len is None else kv_len
    check_attention_lengths(sq, sk, causal=causal, window=window)
    name = variant(q.dtype, d)
    if with_lse and name != "wgmma_bf16":
        raise ValueError("flash_attention_cuda: with_lse takes bf16 inputs "
                         "(the Hopper kernel); the float32 kernel writes no "
                         "lse")
    out = torch.empty_like(q)
    lse = (torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    stream = torch.cuda.current_stream(q.device).cuda_stream
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr())
    if name == "wgmma_bf16":
        # the persistent kernel's count of work items taken, from 0 (freed
        # on return: the allocator reuses it only behind this stream's work)
        next_item = torch.zeros(1, dtype=torch.int32, device=q.device)
        ptrs += (None if lse is None else lse.data_ptr(),
                 next_item.data_ptr())
    dims = (b, hq, hkv, sq, sk, kv_len, d, 1.0 / d ** 0.5, int(causal),
            int(window), stream)
    with torch.cuda.device(q.device):
        err = _kernel(name)(*ptrs, *dims)
    if err < 0:
        raise RuntimeError(f"flash_attention ({name}): cuTensorMapEncodeTiled "
                           f"failed, CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention ({name}) kernel launch failed: "
                           f"cudaError_t {err}")
    launches += 1
    launches_by_variant[name] += 1
    return (out, lse) if with_lse else out


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, *, causal: bool = True,
                             window: int = 0, kv_len: int | None = None,
                             lse: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention_cuda`'s output
    ``o`` against ``do``, by the kernels of :func:`bwd_variant`.

    q, k, v and the mask as :func:`flash_attention_cuda` takes them; ``o``
    its output and ``do`` the output's gradient, both shaped like q, in
    q's dtype, contiguous.  ``lse`` (batch, q_heads, sq) float32, the rows'
    log-sum-exp of the kept scaled scores (+inf where a row keeps none),
    as ``flash_attention_cuda(..., with_lse=True)`` gives it.  Without it,
    the bf16 call runs that forward for it (one more forward launch) and
    the float32 call's first kernel computes it.  dq, dk, dv come in the
    inputs' dtype: float32 within float32 rounding of ``ref.
    attention_bwd_ref``; bf16 within ``ref.attention_bwd_rounding_bound``
    (P and dS rounded to bf16 as operands) and one rounding of the result.
    dk and dv sum over the query heads of a group.  The same inputs give
    the same bits: no float atomics.
    """
    global bwd_launches
    name = "flash_attention_bwd_cuda"
    _check(q, k, v, window, kv_len, name=name)
    for t, arg in ((o, "o"), (do, "do")):
        _check_tensor(name, t, arg)
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{name}: {arg} {tuple(t.shape)} {t.dtype} must "
                             f"match q {tuple(q.shape)} {q.dtype}")
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    if lse is not None and (lse.shape != (b, hq, sq)
                            or lse.dtype != torch.float32
                            or lse.device != q.device):
        raise ValueError(f"{name}: lse must be ({b}, {hq}, {sq}) float32 on "
                         f"{q.device}, got {tuple(lse.shape)} {lse.dtype}")
    check_attention_lengths(sq, sk, causal=causal, window=window)
    mask = dict(causal=causal, window=window, kv_len=kv_len)
    kv_len = sk if kv_len is None else kv_len
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    variant_name = bwd_variant(q.dtype)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scale = 1.0 / d ** 0.5
    if variant_name == "bwd_wgmma_bf16":
        if lse is None:
            _, lse = flash_attention_cuda(q, k, v, with_lse=True, **mask)
        lse = lse.contiguous()
        if lse.data_ptr() % 16:
            lse = lse.clone()
        sms = sm_count(q.device)
        heads = dkdv_heads_per_chunk(b, hq, hkv, sk, sms)
        chunks = math.ceil(hq // hkv / heads)
        # the chunks' float32 dK and dV sums where a group is split
        parts = (torch.empty((2, chunks, b, hkv, sk, d), dtype=torch.float32,
                             device=q.device) if chunks > 1 else None)
        delta = torch.empty((b, hq, sq), dtype=torch.float32,
                            device=q.device)
        # the two kernels' counts of work items taken, from 0
        next_items = torch.zeros(2, dtype=torch.int32, device=q.device)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
                None if parts is None else parts[0].data_ptr(),
                None if parts is None else parts[1].data_ptr(),
                next_items.data_ptr())
        dims = (b, hq, hkv, sq, sk, kv_len, d, scale, int(causal),
                int(window), heads, stream)
        kernels = bwd_kernels(q.dtype, b, hq, hkv, sk, sms)
    else:
        stats = torch.empty((2, b, hq, sq), dtype=torch.float32,
                            device=q.device)
        if lse is not None:
            stats[0].copy_(lse)
        ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                do.data_ptr(), stats[0].data_ptr(), stats[1].data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr())
        dims = (b, hq, hkv, sq, sk, kv_len, d, scale, int(causal),
                int(window), int(lse is not None), stream)
        kernels = BWD_KERNELS[variant_name]
    with torch.cuda.device(q.device):
        err = _bwd_kernel(variant_name)(*ptrs, *dims)
    if err < 0:
        raise RuntimeError(f"flash_attention_bwd ({variant_name}): "
                           f"cuTensorMapEncodeTiled failed, CUresult {-err}")
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd ({variant_name}) kernel "
                           f"launch failed: cudaError_t {err}")
    bwd_launches += 1
    for kernel_name in kernels:
        bwd_launches_by_kernel[kernel_name] += 1
    return dq, dk, dv
