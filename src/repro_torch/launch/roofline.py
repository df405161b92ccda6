"""Roofline terms of a step on one H100, counted over a meta-device run.

A port of the JAX package's ``launch/roofline.py`` on the card's
constants (NVIDIA's data sheet, H100 SXM, dense rates):

  compute    = bf16 FLOPs / 989e12 FLOP/s + float32 FLOPs / 67e12 FLOP/s
  memory     = bytes / 3.35e12 B/s HBM
  collective = collective bytes / 50e9 B/s a GPU between nodes

The collective term exists for a step run on a mesh (``launch/dryrun.py``'s
pod records): its collective bytes a device are counted over the
collectives DTensor issues (:class:`CollectiveCounter`); on one card it is
None.  Under a mesh the FLOPs and bytes are a device's, counted over
each rank's local shapes, as XLA's per-partition cost is.  These terms
are counts over published peaks, not times.  MODEL_FLOPS = 6*N*D (N =
params, active params for MoE; D = tokens) gives the useful-compute
ratio.

Where the JAX package reads ``compiled.cost_analysis()``, the port counts
one run of the step on the meta device (:func:`count_step`), which
allocates nothing:

* **aten ops:** matrix-product FLOPs by ``torch.utils.flop_counter``'s
  formulas, as ``FlopCounterMode`` counts them (float32 operands apart);
  bytes from a ``TorchDispatchMode`` that sums every aten op's operand and
  result bytes, views and bare allocations aside: the eager step's
  traffic, unfused, which is what the port moves.
* **attention:** each flash-attention call (``ops.flash_attention`` and
  ``ops.FlashAttention``, which on a meta tensor reach ``ref``'s plain
  versions) is counted as the card's kernel does the work, not as the
  plain version's full square: the (query, key) pairs that the causal
  band, the window and ``kv_len`` keep (:func:`attention_pairs`), at 4d
  operations a pair forward (two products) and 10d backward (five), q, k,
  v read and o written once (the backward: q, o, do, k, v read and dq,
  dk, dv written), as ``chip_smoke.py``'s bounds reckon them.
* **peak memory:** the largest sum of the meta storages alive at once
  that the run made, beside the bytes of its arguments: the counterpart
  of the JAX record's ``temp_size_in_bytes``.  It sees the step alone:
  not the kernels' own scratch on the card, the allocator's rounding,
  tensors a caller keeps alive around the step, nor what the caller does
  with its output.  :func:`fits_one_card` leaves PEAK_MARGIN for that.
"""

from __future__ import annotations

import contextlib
import re
import time
import weakref

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from ..kernels import ref

HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
FP32_OPS_PER_S = 67e12           # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM bf16 tensor cores, dense
CARD_BYTES = 80e9                # H100 SXM device memory, 80 GB
# Published figures, not measurements: a DGX H100 gives each GPU one 400
# Gb/s NDR ConnectX-7 port between nodes, 50e9 B/s, which every pod term
# takes (each 16-device axis of the pod meshes spans two or more 8-GPU
# NVLink nodes); NVLink 4 moves 450e9 B/s each way within a node, used by
# no pod term
INTERNODE_BYTES_PER_S = 50e9
NVLINK_BYTES_PER_S = 450e9
# how far a step's measured peak may lie from peak_bytes_estimate, as a
# share of the measurement; chip_smoke.py's roofline phase checks it
PEAK_MARGIN = 0.25

_NO_TRAFFIC = {torch.ops.aten.empty, torch.ops.aten.empty_like,
               torch.ops.aten.empty_strided, torch.ops.aten.new_empty,
               torch.ops.aten.new_empty_strided}


def _op_kind(func) -> tuple:
    """(its FLOP formula or None, whether it runs as its parts, whether it
    moves bytes) of an aten op."""
    formula = flop_registry.get(func._overloadpacket)
    composite = formula is None and \
        torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
    # a collective's operands are counted by CollectiveCounter, not here
    moves = not func.is_view and func._overloadpacket not in _NO_TRAFFIC \
        and func.namespace not in ("_c10d_functional", "_dtensor", "c10d")
    return formula, composite, moves


def roofline_terms(cost: dict, coll_bytes: float | None = None) -> dict:
    """The terms in seconds on a card + the dominant one.  ``cost``:
    ``flops``, of them ``flops_float32`` (the CUDA cores' rate: the port
    keeps TF32 off), and ``bytes accessed``, a device's; ``coll_bytes``
    the collective operand bytes a device (None on one card: no
    collective term)."""
    flops = float(cost.get("flops", 0.0))
    f32 = float(cost.get("flops_float32", 0.0))
    terms = {"compute_s": (flops - f32) / BF16_OPS_PER_S
             + f32 / FP32_OPS_PER_S,
             "memory_s": float(cost.get("bytes accessed", 0.0))
             / HBM_BYTES_PER_S,
             "collective_s": None if coll_bytes is None else
             float(coll_bytes) / INTERNODE_BYTES_PER_S}
    numeric = {k: v for k, v in terms.items() if v is not None}
    terms["dominant"] = max(numeric, key=lambda k: numeric[k])[:-2]
    return terms


def fits_one_card(peak_bytes_estimate: float) -> bool | None:
    """Whether a step fits one card: True when its peak estimate is at
    most (1 - PEAK_MARGIN) x 80 GB, so that a peak up to PEAK_MARGIN of
    its measurement above the estimate still fits; False above 80 GB;
    None (unknown) between."""
    if peak_bytes_estimate > CARD_BYTES:
        return False
    if peak_bytes_estimate <= (1 - PEAK_MARGIN) * CARD_BYTES:
        return True
    return None


def model_flops(cfg, n_params: int, n_active_params: int, tokens: int,
                kind: str) -> float:
    """6*N*D (training) or 2*N*D (single forward / decode)."""
    n = n_active_params if cfg.family == "moe" else n_params
    mult = 6.0 if kind == "train" else 2.0
    return mult * n * tokens


def count_params(leaves: dict) -> int:
    """Elements of a state's leaves (path -> tensor,
    ``shardings.param_leaves``)."""
    return sum(t.numel() for t in leaves.values())


def count_active_params(cfg, leaves: dict) -> int:
    """MoE: count routed experts at top_k/n_experts utilisation."""
    total = 0
    for ps, leaf in leaves.items():
        sz = leaf.numel()
        if cfg.family == "moe" and re.search(r"moe/w[igo]$", ps):
            sz = int(sz * cfg.top_k / cfg.n_experts)
        total += sz
    return total


def attention_pairs(sq: int, sk: int, *, causal: bool, window: int,
                    kv_len: int | None = None) -> int:
    """The (query, key) pairs one head keeps: keys below ``kv_len``, at or
    before the query under ``causal``, within ``window`` of it."""
    keys = sk if kv_len is None else min(kv_len, sk)
    i = np.arange(sq, dtype=np.int64)
    hi = np.minimum(i, keys - 1) if causal else np.full(sq, keys - 1)
    lo = np.maximum(i - window + 1, 0) if window > 0 else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


def _tensors(obj) -> list[torch.Tensor]:
    """The tensors in ``obj``: a module's parameters and buffers, the
    leaves of dicts, lists and tuples."""
    out = []
    for leaf in tree_flatten(obj)[0]:
        if isinstance(leaf, torch.nn.Module):
            out += [*leaf.parameters(), *leaf.buffers()]
        elif isinstance(leaf, torch.Tensor):
            out.append(leaf)
    # a DTensor's storage is its local part's: a device's state
    return [getattr(t, "_local_tensor", t) for t in out]


def _key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def state_bytes(*objs) -> int:
    """Bytes of the distinct storages of the tensors in ``objs``."""
    sizes = {_key(t): t.untyped_storage().nbytes() for t in _tensors(objs)}
    return sum(sizes.values())


class StepCounter(TorchDispatchMode):
    """The FLOPs, bytes and live storages of the aten ops that run under
    it, and the work of the flash-attention calls (:meth:`attention`).

    FLOPs are ``torch.utils.flop_counter``'s formulas, applied as
    ``FlopCounterMode`` applies them (its registry, composite ops
    decomposed).  That mode itself is not entered: under it the tensors
    that ``torch.utils.checkpoint`` recomputes in the backward stay alive
    until the step ends, as they do not in a run without it, which would
    inflate the peak.  ``state`` are the tensors made before the run
    (their storages are not the run's).  Only ops on meta tensors count:
    the run's own.  Under DTensor it sees each rank's local ops: a
    device's work."""

    def __init__(self, state: list[torch.Tensor]):
        super().__init__()
        self.state_keys = {_key(t) for t in state}
        self.bytes = 0
        self.flops = self.flops_float32 = 0
        self.attn = {"forward_calls": 0, "backward_calls": 0, "flops": 0,
                     "flops_float32": 0, "bytes": 0}
        self.live = self.peak = 0
        self._owners: dict[int, int] = {}
        self._sizes: dict[int, int] = {}
        self._ops: dict = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            # a device's work: DTensor runs the op on each rank's local
            # part, and those ops come back here
            return NotImplemented
        if _is_fake(types):
            return func(*args, **kwargs)
        if func not in self._ops:
            self._ops[func] = _op_kind(func)
        formula, composite, moves = self._ops[func]
        if composite:
            # a composite op (einsum under inference_mode) runs as its
            # parts, which come back here, as FlopCounterMode counts them
            with self:
                out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        out = func(*args, **kwargs)
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not any(t.device.type == "meta" for t in ins + outs):
            # host bookkeeping (DTensor's shard offsets on CPU tensors,
            # made once and cached): not the step's work
            return out
        if formula is not None:
            n = formula(*args, **kwargs, out_val=out)
            self.flops += n
            if ins and ins[0].dtype == torch.float32:
                self.flops_float32 += n
        if moves:
            self.bytes += sum(t.numel() * t.element_size()
                              for t in ins + outs)
        in_keys = {_key(t) for t in ins}
        for t in outs:
            self._track(t, in_keys)
        return out

    def _track(self, t: torch.Tensor, in_keys: set) -> None:
        """Count ``t``'s storage alive until the last tensor on it that
        the run made dies; storages of the arguments are the state's."""
        key = _key(t)
        if key in self._owners:
            self._owners[key] += 1
        elif key in in_keys or key in self.state_keys:
            return
        else:
            self._owners[key] = 1
            self._sizes[key] = size = t.untyped_storage().nbytes()
            self.live += size
            self.peak = max(self.peak, self.live)
        weakref.finalize(t, self._release, key)

    def _release(self, key: int) -> None:
        self._owners[key] -= 1
        if not self._owners[key]:
            del self._owners[key]
            self.live -= self._sizes.pop(key)

    def attention(self, q, k, *, causal, window, kv_len, backward) -> None:
        """Count one flash-attention call as the card's kernel does it."""
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        pairs = b * hq * attention_pairs(sq, sk, causal=causal,
                                         window=window, kv_len=kv_len)
        flops = pairs * (10 if backward else 4) * d
        rw = 4 if backward else 2
        self.attn["backward_calls" if backward else "forward_calls"] += 1
        self.attn["flops"] += flops
        if q.dtype == torch.float32:
            self.attn["flops_float32"] += flops
        self.attn["bytes"] += q.element_size() * d * rw * (b * hq * sq
                                                            + b * hkv * sk)


def _has_dtensor(types) -> bool:
    from torch.distributed.tensor import DTensor
    return any(issubclass(t, DTensor) for t in types)


def _is_fake(types) -> bool:
    """Whether an op runs on fake tensors: DTensor's sharding rules run an
    op once on fake global shapes to learn its output's shape, work that
    no device does."""
    from torch._subclasses.fake_tensor import FakeTensor
    return any(issubclass(t, FakeTensor) for t in types)


COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def _collective_kinds() -> dict:
    """The functional collectives DTensor issues, by their kind's name."""
    # the modules that register the ops
    import torch.distributed._functional_collectives  # noqa: F401
    import torch.distributed.tensor  # noqa: F401
    f, d = torch.ops._c10d_functional, torch.ops._dtensor
    return {f.all_gather_into_tensor: "all-gather",
            f.all_gather_into_tensor_out: "all-gather",
            f.all_gather_into_tensor_coalesced: "all-gather",
            f.all_reduce: "all-reduce", f.all_reduce_: "all-reduce",
            f.all_reduce_coalesced: "all-reduce",
            f.all_reduce_coalesced_: "all-reduce",
            f.reduce_scatter_tensor: "reduce-scatter",
            f.reduce_scatter_tensor_out: "reduce-scatter",
            f.reduce_scatter_tensor_coalesced: "reduce-scatter",
            f.all_to_all_single: "all-to-all",
            d.shard_dim_alltoall: "all-to-all"}


class CollectiveCounter(TorchDispatchMode):
    """The operand bytes a device of the collectives that run under it, by
    kind (:data:`COLLECTIVES`): the definition of the JAX package's
    ``collective_bytes`` (``launch/roofline.py:50``), counted over the
    functional collectives (``torch.ops._c10d_functional``, and DTensor's
    ``_dtensor.shard_dim_alltoall``) that DTensor issues, forward,
    backward and optimizer alike, where XLA's are parsed from the SPMD
    HLO.  An operand's bytes are those of the local tensor a rank sends
    (an all-gather's shard, a reduce-scatter's whole input), the same on
    the meta device and on the card.  Any other ``c10d`` collective under
    it raises: it would not be counted."""

    def __init__(self):
        super().__init__()
        self.kinds = _collective_kinds()
        f = torch.ops._c10d_functional
        self.uncounted = {f.wait_tensor, f._wrap_tensor_autograd}
        self.bytes = dict.fromkeys(COLLECTIVES, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if _has_dtensor(types):
            # let DTensor run first: the collectives it issues inside an op
            # (a redistribution its sharding rule asks for) come back here
            # on local tensors
            return NotImplemented
        kind = self.kinds.get(func._overloadpacket)
        if kind is not None:
            t = args[0]
            ts = t if isinstance(t, (list, tuple)) else [t]
            self.bytes[kind] += sum(x.numel() * x.element_size() for x in ts)
        elif func.namespace == "c10d" or (
                func.namespace == "_c10d_functional"
                and func._overloadpacket not in self.uncounted):
            raise NotImplementedError(f"collective {func} is not counted")
        return func(*args, **kwargs)


def collective_bytes(fn, *args):
    """``fn(*args)`` run once under a :class:`CollectiveCounter` ->
    (its result, the operand bytes a device by kind)."""
    with CollectiveCounter() as counter:
        out = fn(*args)
    return out, dict(counter.bytes)


@contextlib.contextmanager
def _kernel_attention(counter: StepCounter):
    """Route the flash-attention calls of a meta run to ``counter``: on a
    meta tensor ``ops.flash_attention`` and ``ops.FlashAttention`` reach
    ``ref.attention_ref`` and ``ref.attention_bwd_ref``, replaced here by
    the kernel's shapes and counted work."""
    def check_meta(q):
        if q.device.type != "meta":
            raise ValueError(f"count_step counts meta tensors, got "
                             f"{q.device}")

    def forward(q, k, v, *, causal=True, window=0, kv_len=None):
        check_meta(q)
        ref.check_attention_lengths(q.shape[2], k.shape[2], causal=causal,
                                    window=window)
        counter.attention(q, k, causal=causal, window=window, kv_len=kv_len,
                          backward=False)
        return torch.empty_like(q)

    def backward(q, k, v, o, do, *, causal=True, window=0, kv_len=None,
                 lse=None):
        check_meta(q)
        counter.attention(q, k, causal=causal, window=window, kv_len=kv_len,
                          backward=True)
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)

    real = ref.attention_ref, ref.attention_bwd_ref
    ref.attention_ref, ref.attention_bwd_ref = forward, backward
    try:
        yield
    finally:
        ref.attention_ref, ref.attention_bwd_ref = real


def count_step(fn, *args) -> dict:
    """Run ``fn(*args)`` once on meta tensors and count its work.

    Returns ``flops`` (matrix products and attention), ``flops_float32``
    (their float32 part), ``bytes`` (aten operands and results, and
    attention as the kernel moves it), ``attention`` (the flash calls:
    ``forward_calls``, ``backward_calls`` and their ``flops``,
    ``flops_float32`` and ``bytes``), ``state_bytes`` (the arguments'
    storages), ``peak_bytes`` (the most bytes of storages the run made
    that were alive at once), ``peak_bytes_estimate`` (the two summed)
    and ``seconds``.
    """
    state = _tensors(args)
    t0 = time.perf_counter()
    counter = StepCounter(state)
    with counter, _kernel_attention(counter):
        fn(*args)
    attn = counter.attn
    base = state_bytes(args)
    return {"flops": counter.flops + attn["flops"],
            "flops_float32": counter.flops_float32 + attn["flops_float32"],
            "bytes": counter.bytes + attn["bytes"], "attention": attn,
            "state_bytes": base, "peak_bytes": counter.peak,
            "peak_bytes_estimate": base + counter.peak,
            "seconds": time.perf_counter() - t0}
