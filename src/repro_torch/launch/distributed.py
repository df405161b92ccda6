"""Process groups for the distributed trainer and sharded serving.

The counterpart of the JAX package's ``launch/mesh.py``: where JAX lays
a mesh over devices, this starts one process a worker and joins them in
a ``torch.distributed`` group.

:func:`run` starts ``world_size`` ranks with ``torch.multiprocessing``
(start method ``spawn``, since the ranks use CUDA), joins them through a
``FileStore`` in a temporary directory (no port to clash with another
group on the same host), calls one function on every rank and returns
rank 0's result.  A rank that raises fails the run.  The backend is
gloo on the CPU; on the card NCCL at world size 1, and gloo over CUDA
tensors above it, because NCCL refuses two ranks on one device.

The collectives the port calls go through :func:`all_gather`,
:func:`all_reduce` and :func:`sum_in_rank_order`, which count the
payload each rank receives in :data:`collective_bytes` (an all-gather
``world_size`` times the tensor, an all-reduce the tensor), as
``hist.launches`` counts the histogram's launches.  gloo takes the list
form of ``all_gather``, so that is the one used.  The functional
collectives that DTensor issues on a sharded step over CUDA tensors go
through :class:`GlooCollectives`, which ``models.sharding.logical_rules``
enters on such a mesh.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp
from torch.utils._python_dispatch import TorchDispatchMode

from ..kernels.ops import device_of

collective_bytes = 0
TIMEOUT = datetime.timedelta(minutes=10)


def backend_for(device, world_size: int) -> str:
    """gloo on the CPU; NCCL on the card at world size 1, else gloo."""
    if torch.device(device).type == "cuda" and world_size == 1:
        return "nccl"
    return "gloo"


def all_gather(t: torch.Tensor, group=None) -> list[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order."""
    global collective_bytes
    t = t.contiguous()
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t, group=group)
    collective_bytes += len(out) * t.numel() * t.element_size()
    return out


def all_reduce(t: torch.Tensor, op=dist.ReduceOp.SUM,
               group=None) -> torch.Tensor:
    """``t`` reduced over the group with ``op``, in place; returns ``t``.
    For integers and MIN/MAX, whose results do not depend on the order
    of the reduction."""
    global collective_bytes
    dist.all_reduce(t, op=op, group=group)
    collective_bytes += t.numel() * t.element_size()
    return t


def sum_in_rank_order(t: torch.Tensor, group=None) -> torch.Tensor:
    """The float sum of every rank's ``t`` as ``((t0 + t1) + t2) + ...``:
    the association of XLA:CPU's ``psum``, and the same on every rank,
    which a ring all-reduce is not."""
    parts = all_gather(t, group)
    total = parts[0]
    for p in parts[1:]:
        total = total + p
    return total


class GlooCollectives(TorchDispatchMode):
    """The functional collectives that DTensor issues, on CUDA tensors of
    a gloo group, where gloo's own form fails: an all-gather into one
    tensor (it ends the process on the card) goes through gloo's list
    form, an all-reduce by mean (gloo has none) is a sum divided by the
    group's size.  The same results, in the tensors' own device and
    dtype; every other collective is gloo's own.
    ``roofline.CollectiveCounter`` entered inside it counts the
    functional collective as DTensor issued it.
    ``models.sharding.logical_rules`` enters it on a gloo mesh of CUDA
    tensors (:func:`needs_gloo_forms`), and only there: the GBDT paths
    call gloo's own collectives through this module's functions."""

    def __init__(self):
        super().__init__()
        f = torch.ops._c10d_functional
        self.gather, self.reduce = f.all_gather_into_tensor, f.all_reduce

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        packet = func._overloadpacket
        if packet is self.gather:
            return self._all_gather(*args)
        if packet is self.reduce and args[1] == "avg":
            return self._mean(*args)
        return func(*args, **(kwargs or {}))

    @staticmethod
    def _group(name):
        if isinstance(name, str):
            from torch.distributed.distributed_c10d import \
                _resolve_process_group
            return _resolve_process_group(name)
        return name

    def _all_gather(self, t, group_size, name):
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(group_size)]
        dist.all_gather(parts, t, group=self._group(name))
        return torch.cat(parts)

    def _mean(self, t, op, name):
        group = self._group(name)
        out = t.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out.div_(dist.get_world_size(group))


def needs_gloo_forms(device_mesh) -> bool:
    """Whether a ``DeviceMesh``'s functional collectives need
    :class:`GlooCollectives`: CUDA tensors over a gloo group."""
    return device_mesh.device_type == "cuda" and \
        dist.get_backend(device_mesh.get_group(0)) == "gloo"


def _rank(rank: int, world_size: int, tmp: str, device: str) -> None:
    fn, args, kwargs = torch.load(Path(tmp) / "call.pt", weights_only=False)
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    store = dist.FileStore(str(Path(tmp) / "store"), world_size)
    dist.init_process_group(backend_for(dev, world_size), store=store,
                            rank=rank, world_size=world_size,
                            timeout=TIMEOUT)
    try:
        result = fn(*args, **kwargs)
        if rank == 0:
            torch.save(result, Path(tmp) / "result.pt")
    finally:
        dist.destroy_process_group()


def run(fn, world_size: int, *args, device="cuda", **kwargs):
    """``fn(*args, **kwargs)`` on each of ``world_size`` new ranks, each in
    the default group, on ``device`` ('cuda' raises without a GPU; rank r
    takes card r mod the card count).  Returns rank 0's result (moved
    through ``torch.save``); raises if any rank raises.

    ``fn`` and its arguments are pickled (``fn`` by name: a function at
    the top level of an importable module) into a file that each rank
    loads once it has started.  Passed to the ranks at their start, as the
    spawn start method passes arguments, they would go through a pipe that
    a rank empties only after its imports, so a large argument would start
    the ranks one after another.
    """
    if world_size < 1:
        raise ValueError(f"world_size must be >= 1, got {world_size}")
    device = device_of(device)
    with tempfile.TemporaryDirectory(prefix="repro_torch_group_") as tmp:
        torch.save((fn, args, kwargs), Path(tmp) / "call.pt")
        mp.start_processes(_rank, args=(world_size, tmp, str(device)),
                           nprocs=world_size, join=True,
                           start_method="spawn")
        return torch.load(Path(tmp) / "result.pt", weights_only=False)
