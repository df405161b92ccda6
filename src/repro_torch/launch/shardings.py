"""Parameter / optimizer / input sharding rules, as data.

A port of the JAX package's ``launch/shardings.py``.  The rules are the
same: (regex over the flattened param path) -> per-dimension logical
roles; a role maps to mesh axes only when the dimension size is divisible
by the axes' product (otherwise that dimension is replicated — e.g. MQA
kv projections with 1 head stay replicated rather than splitting a single
head's feature dim across the tensor-parallel axis).  Optimizer m/v get
the ZeRO-1 rule: the largest still-unsharded dimension divisible by the
batch axes is sharded over them.

Where the JAX package returns ``NamedSharding``s, the port returns spec
tuples, the entries of the JAX ``PartitionSpec``: ``None``, an axis name,
or a tuple of axes.  They are keyed by the JAX flat path of each leaf
(``layers/attn/wq/w``, ``m/layers/attn/wq/w``), the leaf the stacked
shape of the port's per-layer parameters (:func:`param_leaves`), so that
the plan is the JAX package's entry for entry.  :func:`bytes_per_device`
gives a state's bytes a device under it, the counterpart of the JAX
record's ``argument_size_in_bytes``.

The plan is applied on a ``DeviceMesh`` (``launch.mesh.device_mesh``):
:func:`placements` turns a spec tuple into DTensor placements, and
:func:`shard_model`, :func:`shard_opt_state`, :func:`shard_batch` and
:func:`shard_decode_state` place a state by it, each per-layer tensor by
its stacked leaf's spec without the stacked axes.
"""

from __future__ import annotations

import math
import re

import torch

from ..checkpoint.npz import _stack_shape, flat_key
from .mesh import batch_axes

# path-regex -> tuple of logical roles per dim (None = replicate)
# roles: 'tp' (model axis), 'ep' (experts over model axis)
_RULES: list[tuple[str, tuple]] = [
    (r"embed/table$", ("tp", None)),              # vocab sharded
    (r"unembed/w$", (None, "tp")),
    (r"(wq|wi|wg|up|wx)/w$", (None, "tp")),       # column parallel
    (r"(mlp|shared)/(wi|wg)$", (None, "tp")),     # MLP dicts hold raw arrays
    (r"(mlp|shared)/wo$", ("tp", None)),
    (r"(wk|wv)/w$", (None, "tp_heads")),          # only if kv heads divide
    (r"(wo|down|out_proj)/w$", ("tp", None)),     # row parallel
    (r"(wq|wk|wv|wi|wg|up|wx)/b$", ("tp",)),
    (r"moe/wi$", ("ep", None, None)),             # expert parallel
    (r"moe/wg$", ("ep", None, None)),
    (r"moe/wo$", ("ep", None, None)),
    (r"in_proj/w$", (None, "tp")),                # mamba2 fused projection
    (r"r$", ("tp", None, None)),                  # slstm recurrent (per head)
    (r"wif/w$", (None, None)),
]

FSDP_THRESHOLD_BYTES = 4 << 30   # per-device params beyond this -> FSDP


def param_leaves(named) -> dict[str, torch.Tensor]:
    """The JAX package's leaves of (name, tensor) pairs (a model's
    ``named_parameters()``, an AdamW moment dict's ``items()``): each JAX
    flat path (``checkpoint.npz.flat_key``) to a meta tensor of its
    stacked shape, stacked axes first, and its dtype."""
    grouped: dict[str, list] = {}
    for name, t in named:
        key, index = flat_key(name)
        grouped.setdefault(key, []).append((index, t))
    out = {}
    for key, items in grouped.items():
        index, t = items[0]
        lead = () if index is None else _stack_shape([i for i, _ in items])
        out[key] = torch.empty(lead + tuple(t.shape), dtype=t.dtype,
                               device="meta")
    return out


def opt_leaves(opt_state: dict) -> dict[str, torch.Tensor]:
    """An AdamW state's leaves by JAX flat path: ``m/<param path>``,
    ``v/<param path>`` and ``step``."""
    out = {f"{part}/{k}": t for part in ("m", "v")
           for k, t in param_leaves(opt_state[part].items()).items()}
    out["step"] = opt_state["step"].to("meta")
    return out


def param_spec(path_str: str, shape, mesh, cfg=None) -> tuple:
    """Spec tuple for one parameter."""
    m = mesh.shape.get("model", 1)
    for pat, roles in _RULES:
        if re.search(pat, path_str):
            spec = []
            # stacked-layer leading axes (scan stacking) are replicated;
            # roles apply to the trailing dims
            extra = len(shape) - len(roles)
            spec.extend([None] * extra)
            for dim, role in zip(shape[extra:], roles):
                if role in ("tp", "ep") and dim % m == 0:
                    spec.append("model")
                elif role == "tp_heads" and cfg is not None and \
                        cfg.n_kv_heads % m == 0 and dim % m == 0:
                    spec.append("model")
                else:
                    spec.append(None)
            return tuple(spec)
    return ()  # norms, scalars, routers: replicated


def zero_extend(spec: tuple, shape, mesh) -> tuple:
    """ZeRO-1: shard the largest unsharded dim of optimizer state over
    'data' (and 'pod' when present, for the multi-pod mesh)."""
    axes = [a for a in ("pod", "data") if a in mesh.axis_names]
    n = math.prod(mesh.shape[a] for a in axes)
    parts = list(spec) + [None] * (len(shape) - len(spec))
    best, best_dim = -1, 0
    for i, (s, dim) in enumerate(zip(parts, shape)):
        if s is None and dim % n == 0 and dim > best_dim:
            best, best_dim = i, dim
    if best >= 0:
        parts[best] = tuple(axes) if len(axes) > 1 else axes[0]
    return tuple(parts)


def _shards(spec: tuple, mesh) -> int:
    """The devices one leaf is split over under ``spec``."""
    n = 1
    for s in spec:
        if s is None:
            continue
        for a in (s if isinstance(s, tuple) else (s,)):
            n *= mesh.shape[a]
    return n


def bytes_per_device(leaves: dict, specs: dict, mesh) -> int:
    """The bytes one device holds of ``leaves`` (path -> tensor) under
    ``specs`` (path -> spec tuple): each leaf's bytes over the devices it
    is split over, rounded down, as the JAX package counts them."""
    return sum(t.numel() * t.element_size() // _shards(specs[k], mesh)
               for k, t in leaves.items())


def _tp_only_bytes_per_device(leaves: dict, mesh, cfg) -> int:
    return bytes_per_device(
        leaves, {k: param_spec(k, t.shape, mesh, cfg)
                 for k, t in leaves.items()}, mesh)


def use_fsdp(leaves: dict, mesh, cfg=None) -> bool:
    """The FSDP decision of :func:`param_shardings`: the TP-only
    per-device footprint exceeds FSDP_THRESHOLD_BYTES."""
    return _tp_only_bytes_per_device(leaves, mesh,
                                     cfg) > FSDP_THRESHOLD_BYTES


def param_shardings(leaves: dict, mesh, cfg=None) -> dict:
    """Spec tuples of the parameter leaves (:func:`param_leaves`), by path.

    ZeRO-3/FSDP-style extra sharding of every param over the data axes
    when :func:`use_fsdp` (the 235B MoE and the deep granite stacks need
    it).
    """
    fs = use_fsdp(leaves, mesh, cfg)

    def one(path, leaf):
        spec = param_spec(path, leaf.shape, mesh, cfg)
        return zero_extend(spec, leaf.shape, mesh) if fs else spec
    return {k: one(k, t) for k, t in leaves.items()}


def opt_shardings(leaves: dict, mesh, cfg=None) -> dict:
    """Optimizer-state spec tuples (:func:`opt_leaves`): param rule +
    ZeRO-1 extension on m/v, the step counter replicated."""
    def one(path, leaf):
        if path.startswith(("m/", "v/")):
            spec = param_spec(re.sub(r"^(m|v)/", "", path), leaf.shape,
                              mesh, cfg)
            return zero_extend(spec, leaf.shape, mesh)
        return ()  # step counter
    return {k: one(k, t) for k, t in leaves.items()}


def batch_spec(shape, mesh) -> tuple:
    """Shard the leading (batch) dim over the batch axes when divisible."""
    axes = batch_axes(mesh)
    n = math.prod(mesh.shape[a] for a in axes)
    if shape and shape[0] % n == 0 and shape[0] > 0:
        lead = tuple(axes) if len(axes) > 1 else axes[0]
        return (lead, *([None] * (len(shape) - 1)))
    return tuple([None] * len(shape))


def batch_shardings(batch: dict, mesh) -> dict:
    return {k: batch_spec(tuple(t.shape), mesh) for k, t in batch.items()}


def placements(spec: tuple, mesh) -> tuple:
    """DTensor placements of a spec tuple on a ``DeviceMesh``: the tensor
    dim whose entry names a mesh axis is ``Shard(dim)`` on that mesh dim,
    every other mesh dim ``Replicate()``.  An entry of several axes
    (``("pod", "data")``) shards its one dim over each of them, major to
    minor in mesh order, as JAX lays it out."""
    from torch.distributed.tensor import Replicate, Shard
    from .mesh import mesh_dims
    out = [Replicate()] * mesh.ndim
    for dim, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        order = [a for n in mesh.mesh_dim_names for a in n.split("+")]
        if [order.index(a) for a in axes] != sorted(order.index(a)
                                                   for a in axes):
            raise ValueError(f"spec entry {entry} is not in the mesh's "
                             f"axis order {order}")
        for m in mesh_dims(mesh, axes):
            out[m] = Shard(dim)
    return tuple(out)


def _placed(t: torch.Tensor, spec: tuple, device_mesh):
    """``t``, which every rank holds whole, as a ``DTensor`` placed by
    ``spec``; each rank keeps its own part, no collective."""
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, device_mesh, placements(spec, device_mesh),
                             src_data_rank=None)


def _leaf_specs(named, plan: dict, own, prefix: str = "") -> dict:
    """Each (name, tensor)'s spec, keyed by parameter name: its stacked
    leaf's (``plan``, by JAX flat path) without the stacked leading axes,
    which :func:`param_spec` leaves replicated.  Where the ZeRO extension
    put the batch axes on a stacked axis (the layer axis the longest, as
    in a stacked bias), which a per-layer tensor has not, it is
    ``own(path, tensor)``: the same rule on the tensor's own dims."""
    out = {}
    for name, t in named:
        path = flat_key(name)[0]
        spec = plan[prefix + path]
        lead = len(spec) - t.ndim
        out[name] = (own(path, t) if lead > 0 and any(
            s is not None for s in spec[:lead]) else spec[max(lead, 0):])
    return out


def shard_model(model, device_mesh, cfg=None):
    """The model's parameters placed by :func:`param_shardings` on
    ``device_mesh`` (IN PLACE; returns the model).  Every rank holds the
    same model; each keeps its part.  A per-layer tensor takes its
    stacked leaf's spec without the stacked axes (:func:`_leaf_specs`)."""
    from .mesh import shape_of
    mesh = shape_of(device_mesh)
    params = list(model.named_parameters())
    leaves = param_leaves(params)

    def own(path, t):
        spec = param_spec(path, t.shape, mesh, cfg)
        return zero_extend(spec, t.shape, mesh) if use_fsdp(
            leaves, mesh, cfg) else spec
    specs = _leaf_specs(params, param_shardings(leaves, mesh, cfg), own)
    for name, p in params:
        path, _, attr = name.rpartition(".")
        owner = model.get_submodule(path) if path else model
        setattr(owner, attr, torch.nn.Parameter(
            _placed(p.detach(), specs[name], device_mesh),
            requires_grad=p.requires_grad))
    return model


def shard_opt_state(opt_state: dict, device_mesh, cfg=None) -> dict:
    """An AdamW state placed by :func:`opt_shardings`: m and v by the
    parameter rule with the ZeRO-1 extension over the batch axes; the
    step counter replicated (kept a plain tensor)."""
    from .mesh import shape_of
    mesh = shape_of(device_mesh)
    plan = opt_shardings(opt_leaves(opt_state), mesh, cfg)

    def own(path, t):
        return zero_extend(param_spec(path, t.shape, mesh, cfg), t.shape,
                           mesh)
    out = {"step": opt_state["step"]}
    for part in ("m", "v"):
        specs = _leaf_specs(opt_state[part].items(), plan, own, f"{part}/")
        out[part] = {n: _placed(t, specs[n], device_mesh)
                     for n, t in opt_state[part].items()}
    return out


def grad_placements(opt_state: dict) -> dict:
    """Parameter name -> the placements of its AdamW moment m: where
    ``make_train_step(grad_shardings=)`` pins the gradients."""
    return {n: t.placements for n, t in opt_state["m"].items()}


def shard_batch(batch: dict, device_mesh) -> dict:
    """Model inputs placed by :func:`batch_shardings`: the batch axis over
    the batch axes where they divide it."""
    from .mesh import shape_of
    specs = batch_shardings(batch, shape_of(device_mesh))
    return {k: _placed(t, specs[k], device_mesh) for k, t in batch.items()}


def shard_decode_state(state, specs, device_mesh):
    """A decode state placed by its spec tuples
    (``specs.decode_state_shardings``, nested as the state is)."""
    if isinstance(state, dict):
        return {k: shard_decode_state(state[k], specs[k], device_mesh)
                for k in state}
    if isinstance(state, tuple):
        return tuple(shard_decode_state(t, s, device_mesh)
                     for t, s in zip(state, specs))
    return _placed(state, specs, device_mesh)


def maybe(axis_or_axes, dim: int, mesh) -> object:
    """Return the axis spec entry if ``dim`` divides its device count."""
    axes = (axis_or_axes if isinstance(axis_or_axes, tuple)
            else (axis_or_axes,))
    n = math.prod(mesh.shape[a] for a in axes if a in mesh.axis_names)
    if all(a in mesh.axis_names for a in axes) and dim % n == 0 and dim > 0:
        return axis_or_axes if isinstance(axis_or_axes, tuple) and \
            len(axis_or_axes) > 1 else axes[0]
    return None
