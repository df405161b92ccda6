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
form of ``all_gather``, so that is the one used.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from pathlib import Path

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

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
