"""Production mesh shapes, as data.

A port of the JAX package's ``launch/mesh.py``.  There a mesh is a
``jax.sharding.Mesh`` over devices; here it is a :class:`MeshShape`, the
axes and their sizes and nothing else: no process group, no device.  The
sharding plan (``launch/shardings.py``) reads only a mesh's axis names and
sizes, so it is computed for the production pods on any machine, and the
dry-run (``launch/dryrun.py``) gives each state's bytes a device under
them.  The port runs on one card.
"""

from __future__ import annotations

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
