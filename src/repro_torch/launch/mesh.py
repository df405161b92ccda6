"""Production mesh shapes, as data.

A port of the JAX package's ``launch/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` over devices; here it is a :class:`MeshShape`, the
axes and their sizes and nothing else: no process group, no device.  The
sharding plan (``launch/shardings.py``) reads only a mesh's axis names and
sizes, so it is computed for the production pods on any machine, and the
dry-run (``launch/dryrun.py``) gives each state's bytes a device under
them.

A ``MeshShape`` stays the plan's input; what applies the plan is a
``torch.distributed`` ``DeviceMesh`` of the same axes over the current
process group (:func:`device_mesh`): the ranks of
``launch.distributed.run``, or, for a count on the meta device, the fake
group of :func:`fake_group`, which stands in for 256 or 512 devices in
one process.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A device mesh as data: ``axis_names`` in order and ``shape``, each
    axis's size by name (``jax.sharding.Mesh.shape``'s layout)."""
    axis_names: tuple[str, ...]
    shape: dict[str, int]

    @property
    def size(self) -> int:
        """The mesh's device count."""
        return math.prod(self.shape.values())


def _mesh(sizes: tuple[int, ...], axes: tuple[str, ...]) -> MeshShape:
    return MeshShape(axes, dict(zip(axes, sizes)))


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single pod (256 chips) or 2x16x16 two-pod (512 chips)."""
    if multi_pod:
        return _mesh((2, 16, 16), ("pod", "data", "model"))
    return _mesh((16, 16), ("data", "model"))


def make_debug_mesh(n_data: int = 2, n_model: int = 2) -> MeshShape:
    """A small (data, model) mesh."""
    return _mesh((n_data, n_model), ("data", "model"))


def mesh_tag(mesh: MeshShape) -> str:
    """The dry-run's name of a mesh: ``pod16x16``, ``pod2x16x16``."""
    return "pod" + "x".join(str(mesh.shape[a]) for a in mesh.axis_names)


def batch_axes(mesh) -> tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def n_batch_devices(mesh) -> int:
    out = 1
    for a in batch_axes(mesh):
        out *= mesh.shape[a]
    return out


# Axes the plan names only together, in this order (the batch axes, the
# ZeRO axes of the multi-pod mesh): one dim of the DeviceMesh, named by
# joining them with "+".  Each tensor's partition over the devices is the
# same (the dim is pod-major, as the JAX mesh lays its devices out), read
# as XLA reads a dim split over both axes: one split of their product.
# On three dims DTensor reduces one dim at a time, gathers a batch split
# twice before a reshape, and plans each move ~50x slower.
MERGED = (("pod", "data"),)


def device_mesh(mesh: MeshShape, device_type: str = "cuda"):
    """A ``DeviceMesh`` of ``mesh``'s axes and sizes over the current
    process group (``init_device_mesh``), whose size must be the mesh's;
    the axes of :data:`MERGED` as one dim.  ``device_type``: the ranks'
    devices ('cuda' or 'cpu').  A count on the meta device
    (:func:`fake_group`) takes 'cuda': DTensor then issues what an NCCL
    mesh of cards runs (a shard-to-shard move as one all-to-all), where a
    'cpu' mesh replaces an all-to-all by an all-gather (gloo has none).
    The mesh keeps ``mesh`` as ``plan_shape`` (:func:`shape_of`)."""
    from torch.distributed.device_mesh import init_device_mesh
    names, sizes, axes = [], [], list(mesh.axis_names)
    while axes:
        group = next((g for g in MERGED if tuple(axes[:len(g)]) == g),
                     axes[:1])
        names.append("+".join(group))
        sizes.append(math.prod(mesh.shape[a] for a in group))
        axes = axes[len(group):]
    dm = init_device_mesh(device_type, tuple(sizes),
                          mesh_dim_names=tuple(names))
    dm.plan_shape = mesh
    return dm


def shape_of(device_mesh) -> MeshShape:
    """The :class:`MeshShape` a ``DeviceMesh`` of :func:`device_mesh`
    applies."""
    return device_mesh.plan_shape


def mesh_dims(device_mesh, axes) -> list[int]:
    """The dims of a ``DeviceMesh`` that hold the mesh axes ``axes``, in
    mesh order; a merged dim (:data:`MERGED`) only with all its axes."""
    out = []
    for i, name in enumerate(device_mesh.mesh_dim_names):
        members = name.split("+")
        if any(a in axes for a in members):
            if not all(a in axes for a in members):
                raise ValueError(f"axes {axes} split the mesh dim {name}")
            out.append(i)
    missing = set(axes) - {a for i in out
                           for a in device_mesh.mesh_dim_names[i].split("+")}
    if missing:
        raise ValueError(f"axes {sorted(missing)} are not in the mesh "
                         f"{device_mesh.mesh_dim_names}")
    return out


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks in this process, this
    one rank 0, for a run on meta tensors: its collectives move nothing
    and return at once.  Destroyed on exit, so that one process runs
    both pod meshes in turn."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()
