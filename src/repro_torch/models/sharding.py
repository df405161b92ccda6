"""Logical-axis sharding constraints for model activations.

A port of the JAX package's ``models/sharding.py``.  Models annotate
activations with *logical* axes ('batch', 'seq', 'embed', 'heads', 'ff',
'vocab', 'experts', ...).  The launcher installs a mapping from logical
axes to mesh axes, with the ``DeviceMesh`` it applies to
(:func:`logical_rules`; single-pod and multi-pod differ only in the
'batch' mapping).  Where no mapping is installed, or the activation is a
plain tensor and not a ``DTensor``, :func:`constrain` is a no-op, so the
same model code runs on one card and on a mesh.

Where the JAX package pins a layout with ``with_sharding_constraint``,
the port redistributes the ``DTensor`` to the placements of the same
spec (``launch.shardings.placements``): a pending sum (``Partial``) is
all-reduced or reduce-scattered there, a shard gathered or moved.
Where DTensor has no rule for a region, or a hand-written kernel runs,
the model runs it on each rank's local parts (:func:`local`, as
``local_map`` runs a function, at the placements those constraints give).
A dim that its mesh axes do not split evenly is split all the same, as
``torch.chunk`` splits it, where XLA pads it (14 heads over 16 ranks:
one on each of the first 14), so that a device's work is its share and
no path falls back to a replicated tensor; only a reshape that DTensor
cannot split that way gathers first (:func:`unflatten`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import types

import torch

# process-wide, not per thread: autograd runs a card's backward, and the
# recomputation of each checkpointed block in it, on a thread of its own
_state = types.SimpleNamespace(rules=None, mesh=None)

# Default logical->mesh mapping used by the production launcher.
SINGLE_POD_RULES = {
    "batch": ("data",),
    "seq": None,
    "embed": None,
    "heads": ("model",),
    "kv_heads": ("model",),
    "ff": ("model",),
    "vocab": ("model",),
    "experts": ("model",),
    "expert_cap": None,
    "state": None,
}

MULTI_POD_RULES = dict(SINGLE_POD_RULES, batch=("pod", "data"))


def rules_for_mesh(mesh, seq_shard: bool = False) -> dict:
    """seq_shard=True turns on Megatron-style sequence parallelism: the
    residual stream (and everything constrained on 'seq') is sharded over
    the tensor-parallel axis between blocks, dividing saved remat
    activations by the model-axis size at the cost of gather/scatter
    collectives around attention/MLP.  ``mesh``: anything with
    ``axis_names`` (a ``MeshShape``)."""
    rules = MULTI_POD_RULES if "pod" in mesh.axis_names else SINGLE_POD_RULES
    if seq_shard:
        rules = dict(rules, seq=("model",))
    return rules


@contextlib.contextmanager
def logical_rules(rules: dict | None, mesh=None):
    """Install a logical->mesh mapping, and the ``DeviceMesh`` the model's
    ``DTensor``s live on (``launch.mesh.device_mesh``), for the enclosed
    run.  With a mesh, a plain tensor that meets a ``DTensor`` (a
    constant, the optimizer's step) counts as replicated
    (``implicit_replication``), and on a gloo mesh of CUDA tensors (two
    ranks of one card) the functional collectives that DTensor issues take
    the forms gloo has (``launch.distributed.GlooCollectives``)."""
    prev = _state.rules, _state.mesh
    _state.rules, _state.mesh = rules, mesh
    try:
        with contextlib.ExitStack() as stack:
            if mesh is not None:
                from torch.distributed.tensor.experimental import \
                    implicit_replication
                from ..launch import distributed
                stack.enter_context(implicit_replication())
                if distributed.needs_gloo_forms(mesh):
                    stack.enter_context(distributed.GlooCollectives())
            yield
    finally:
        _state.rules, _state.mesh = prev


def current_rules() -> dict | None:
    return _state.rules


def current_mesh():
    """The ``DeviceMesh`` installed by :func:`logical_rules`, or None."""
    return _state.mesh


def spec(*logical_axes) -> tuple:
    """The spec tuple (a JAX ``PartitionSpec``'s entries: None, an axis, or
    a tuple of axes) for the given logical axes under the current rules;
    ``()`` when none are installed."""
    rules = current_rules()
    if rules is None:
        return ()
    out = []
    used: set = set()
    for ax in logical_axes:
        m = rules.get(ax) if ax is not None else None
        if m is None or any(a in used for a in m):
            # a mesh axis may appear once per spec — later logical axes
            # that would reuse one (e.g. vocab when seq already holds
            # 'model' under sequence parallelism) fall back to replicated
            out.append(None)
            continue
        used.update(m)
        out.append(m[0] if len(m) == 1 else tuple(m))
    return tuple(out)


def is_sharded(x) -> bool:
    """Whether ``x`` is a ``DTensor`` under installed rules: what
    :func:`constrain` acts on."""
    if current_rules() is None:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def constrain(x, *logical_axes):
    """``x`` redistributed to the placements of :func:`spec` on the
    current mesh (the JAX package's ``with_sharding_constraint``); ``x``
    itself when no rules are installed or ``x`` is not a ``DTensor``.  A
    dim that its mesh axes do not split evenly is split all the same, as
    ``torch.chunk`` splits it (14 heads over 16 ranks: one head on each
    of the first 14, none on the last two), where XLA pads it: either way
    a device holds at most the larger share.

    Its gradient is redistributed to the same placements, as JAX
    transposes the constraint into the same constraint on the cotangent:
    a gradient that is a pending sum (the residual stream's, from the
    column-parallel products it feeds) is all-reduced there, not carried
    on into the products before it."""
    if not is_sharded(x):
        return x
    return _Constrain.apply(x, placements_of(*logical_axes))


class _Constrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        ctx.placements = placements
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(g.device_mesh, ctx.placements), None


def operand(x, *logical_axes):
    """A parameter laid out as the product it feeds wants it: ``x``
    redistributed to the placements of the logical axes, where XLA would
    carry a constraint on the product's output back into its operand.
    Unlike :func:`constrain`, its gradient is left as the product gives it
    (a pending sum over the batch, a split of the rows), to be reduced once
    where the step places the parameters' gradients, not at every use.
    ``x`` itself when no rules are installed or it is not a ``DTensor``."""
    if not is_sharded(x):
        return x
    return _Operand.apply(x, placements_of(*logical_axes))


class _Operand(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, placements):
        return x.redistribute(x.device_mesh, placements)

    @staticmethod
    def backward(ctx, g):
        return g, None


def gathered(x, dim: int):
    """``x`` with its ``dim`` whole on every rank (a ``DTensor`` sharded
    there all-gathered; anything else as it is)."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(placements=[
        Replicate() if p.is_shard(dim) else p for p in x.placements])


def even_splits(x):
    """``x`` with each dim that its mesh axes split unevenly gathered
    (whole on every rank), for an op that DTensor runs through views
    that need even splits (an einsum folding a batch dim of one decode
    row over 16 ranks into its product); ``x`` itself where every split
    is even, or without a mesh."""
    if not is_sharded(x):
        return x
    from torch.distributed.tensor import Replicate
    uneven = {p.dim for p in x.placements
              if p.is_shard() and x.shape[p.dim] % _parts(x, p.dim)}
    if not uneven:
        return x
    return x.redistribute(placements=[
        Replicate() if p.is_shard() and p.dim in uneven else p
        for p in x.placements])


def unflatten(t, heads: int, head_dim: int):
    """``t`` (..., heads * head_dim) as (..., heads, head_dim): a
    projection's output as heads.  On a mesh a split that the heads do not
    take evenly (14 heads over 16 ranks) is gathered first, and so is the
    gradient's on the way back: DTensor splits and merges dims only along
    an even split of the first (XLA reshards there too)."""
    if not is_sharded(t):
        return t.reshape(*t.shape[:-1], heads, head_dim)
    return _Heads.apply(t, (heads, head_dim))


def flatten(t):
    """``t`` (..., heads, head_dim) as (..., heads * head_dim), the
    inverse of :func:`unflatten`, with its gathers."""
    if not is_sharded(t):
        return t.reshape(*t.shape[:-2], -1)
    return _Heads.apply(t, None)


def _parts(t, dim: int) -> int:
    """The parts a ``DTensor``'s ``dim`` is split into."""
    n = 1
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            n *= t.device_mesh.size(i)
    return n


def _split(t, sizes):
    if sizes[0] % _parts(t, t.ndim - 1):
        t = gathered(t, t.ndim - 1)
    return t.reshape(*t.shape[:-1], *sizes)


def _merge(t):
    if t.shape[-2] % _parts(t, t.ndim - 2):
        t = gathered(t, t.ndim - 2)
    return gathered(t, t.ndim - 1).reshape(*t.shape[:-2], -1)


class _Heads(torch.autograd.Function):
    """Split the last dim into ``sizes`` (or merge the last two with None),
    gathering where the split is uneven, both ways."""

    @staticmethod
    def forward(ctx, t, sizes):
        ctx.sizes, ctx.last_two = sizes, tuple(t.shape[-2:])
        return _merge(t) if sizes is None else _split(t, sizes)

    @staticmethod
    def backward(ctx, g):
        if ctx.sizes is None:
            return _split(g, ctx.last_two), None
        return _merge(g), None


def axis_size(logical_axis: str) -> int:
    """Devices the current rules split ``logical_axis`` over (1 when none
    are installed or the axis is replicated)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or mesh is None or rules.get(logical_axis) is None:
        return 1
    n = 1
    for i in _dims(rules[logical_axis]):
        n *= mesh.size(i)
    return n


def _dims(axes) -> list[int]:
    """The current mesh's dims that hold the mesh axes ``axes``."""
    from ..launch.mesh import mesh_dims
    return mesh_dims(current_mesh(), axes)


def placements_of(*logical_axes) -> tuple:
    """The current mesh's placements for the logical axes."""
    from ..launch.shardings import placements
    return placements(spec(*logical_axes), current_mesh())


def distribute(t, *logical_axes):
    """A plain tensor that every rank holds whole (positions, masks) as a
    ``DTensor`` of the logical axes' placements (an uneven split as
    :func:`constrain` makes it), each rank keeping its own part: no
    collective.  ``t`` itself when no rules are installed or it is a
    ``DTensor`` already."""
    if current_rules() is None or is_sharded(t):
        return t
    from torch.distributed.tensor import distribute_tensor
    return distribute_tensor(t, current_mesh(), placements_of(*logical_axes),
                             src_data_rank=None)


def local(fn, out_axes, *in_axes, partial_grads=None):
    """``fn`` run on each rank's local parts of its ``DTensor`` arguments:
    the placements of ``in_axes`` (one tuple of logical axes an argument,
    or its DTensor placements; None for a non-tensor) and ``out_axes``
    (one tuple or :class:`Pending`, or a list of them for several
    outputs, or none), as ``local_map`` runs a function.
    The inputs are redistributed to their placements first (a split that
    is not even as :func:`constrain` makes it), and the outputs are
    ``DTensor``s of theirs, whose global sizes are those of the inputs'
    dims of the same logical axes (so a rank's share of an uneven split
    may be smaller than another's, or empty).  The gradient of an input is
    placed as the input, except for those in ``partial_grads`` (argument
    index -> logical axes): each rank's gradient of such an input is its
    part of a sum over those axes' mesh axes (a table each rank reads
    some rows of for its batch, kv heads each rank reads for some query
    heads).  This is where a hand-written kernel, or a region DTensor has
    no rule for, runs on local shards, as the JAX package's ``constrain``
    calls around it place them.  On arguments none of which is a
    ``DTensor`` (no mesh) it is ``fn`` itself."""
    partial_grads = partial_grads or {}
    out_axes = out_axes if isinstance(out_axes, list) else [out_axes]

    def call(*args):
        from torch.distributed.tensor import DTensor
        if not any(isinstance(a, DTensor) for a in args):
            return fn(*args)
        sizes, local_args = {}, []
        for i, (a, axes) in enumerate(zip(args, in_axes)):
            if not isinstance(a, DTensor):
                local_args.append(a)
                continue
            place = _placements(axes)
            if a.placements != place:
                a = a.redistribute(a.device_mesh, place)
            if not _explicit(axes):
                sizes.update((ax, n) for ax, n in zip(axes, a.shape)
                             if ax is not None)
            grad = (_placements(Pending(axes, partial_grads[i]))
                    if i in partial_grads else place)
            t = a.to_local(grad_placements=grad)
            # a DTensor made from a local tensor takes its strides, so
            # every tensor that crosses the region's edge, either way, is
            # contiguous
            local_args.append(_ContiguousGrad.apply(t) if t.requires_grad
                              else t)
        out = fn(*local_args)
        one = not isinstance(out, tuple)
        out = tuple(_global(t, axes, sizes)
                    for t, axes in zip((out,) if one else out, out_axes))
        return out[0] if one else out
    return call


def _global(t, axes, sizes: dict):
    """A region's local output ``t`` as the ``DTensor`` of the placements
    of ``axes``; a dim split over ranks takes the global size of its
    logical axis from ``sizes`` (an even split's: the local size times
    the parts)."""
    if not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor
    mesh, place = current_mesh(), _placements(axes)
    logical = () if _explicit(axes) else (
        axes.axes if isinstance(axes, Pending) else axes)
    shape = list(t.shape)
    for d in range(t.ndim):
        parts = 1
        for i, p in enumerate(place):
            if p.is_shard(d):
                parts *= mesh.size(i)
        if parts > 1:
            ax = logical[d] if d < len(logical) else None
            shape[d] = sizes.get(ax, shape[d] * parts)
    t = t.contiguous()
    stride, n = [1] * t.ndim, 1
    for d in reversed(range(t.ndim)):
        stride[d], n = n, n * shape[d]
    return DTensor.from_local(t, mesh, place, run_check=False,
                              shape=torch.Size(shape), stride=tuple(stride))


def _explicit(axes) -> bool:
    from torch.distributed.tensor import Placement
    return isinstance(axes, tuple) and bool(axes) and all(
        isinstance(a, Placement) for a in axes)


@dataclasses.dataclass(frozen=True)
class Pending:
    """The placements of the logical ``axes``, with a pending sum
    (``Partial``) over the mesh axes of the logical axes ``over``."""
    axes: tuple
    over: tuple


def _placements(axes):
    """The current mesh's placements of a tuple of logical axes or a
    :class:`Pending` (placements given as such kept); None for a
    non-tensor."""
    if axes is None or _explicit(axes):
        return axes                          # placements already
    if not isinstance(axes, Pending):
        return placements_of(*axes)
    from torch.distributed.tensor import Partial
    out = list(placements_of(*axes.axes))
    for ax in axes.over:
        for i in _dims(current_rules().get(ax) or ()):
            out[i] = Partial()
    return tuple(out)


def local_index(logical_axis: str) -> int:
    """This rank's index among the parts that ``logical_axis`` is split
    into (0 when it is not split)."""
    rules, mesh = current_rules(), current_mesh()
    if rules is None or rules.get(logical_axis) is None:
        return 0
    idx = 0
    for i in _dims(rules[logical_axis]):
        idx = idx * mesh.size(i) + mesh.get_local_rank(i)
    return idx


def local_share(logical_axis: str, size: int) -> tuple[int, int]:
    """(the first index, the count) of this rank's part of a dim of
    ``size`` split over ``logical_axis`` as DTensor splits it
    (``torch.chunk``: parts of ceil(size / n), the last ones smaller or
    empty); (0, size) when it is not split."""
    n = axis_size(logical_axis)
    per = -(-size // n)
    first = min(local_index(logical_axis) * per, size)
    return first, min(per, size - first)


class _ContiguousGrad(torch.autograd.Function):
    """The identity, whose gradient is made contiguous."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()
