"""Dry-run on the meta device: count every (arch x input shape) step on
one H100's constants, with the sharding plan's bytes at the pod meshes.

A port of the JAX package's ``launch/dryrun.py``.  The JAX dry-run lowers
and compiles each step on 512 placeholder CPU devices; the port runs it
once on the meta device (``launch/roofline.py``: ``count_step``), which
allocates nothing and needs no card, and records:

* ``n_params``, ``n_active_params``, ``model_flops`` (6ND / 2ND);
* ``flops`` (of them ``flops_float32``) and ``bytes_accessed``, the
  flash-attention calls counted as the card's kernel does the work;
* ``state_bytes`` (parameters, AdamW state, inputs, decode state) and
  ``peak_bytes_estimate``, ``fits_one_card`` against the card's 80 GB
  (None, unknown, within ``roofline.PEAK_MARGIN`` of it);
* ``state_bytes_per_device`` and ``fsdp`` at ``pod16x16`` and
  ``pod2x16x16`` from the sharding plan (``launch/shardings.py``);
* ``roofline`` on one card and ``useful_flops_ratio``
  (``model_flops / flops``).

No ``delta_detail``: on the meta device every unit of a uniform stack
counts the same, so the JAX package's extrapolation from the 1- and
2-unit variants equals the full count (``tests/test_torch_dryrun.py``
shows it); ``hillclimb --fast`` counts the 1-unit variant
(:func:`count_cost` of :func:`_delta_cfg`) itself.

The ssm family's sLSTM is a Python loop over tokens, and each step of it
is a few dozen meta ops at a few hundred microseconds each: xlstm-125m's
full runs are the sweep's slowest (PERF.md gives their seconds).

**The sharded pass** (``pod16x16``, ``pod2x16x16``; the JAX package's
compile on 512 placeholder devices): the step under the sharding plan
on meta tensors, in a fake process group of 256 / 512 ranks
(``launch.mesh.fake_group``), the parameters, AdamW state, batch and
decode state ``DTensor``s placed by ``launch/shardings.py``, the model's
``constrain`` calls under ``models/sharding.py``'s rules (``seq_shard``
for train shapes) and ``moe_groups`` set to the batch devices, as the JAX
package's ``build_lowered`` does.  Its record: ``status`` (the lowering
proof: every op's placement resolved), ``collective_bytes`` a device by
kind (``roofline.CollectiveCounter``), and at ``pod16x16`` a device's
``flops`` and ``bytes_accessed`` (each rank's local shapes) and the
``roofline`` with its collective term.  DTensor dispatch costs far more
an op than the plain meta run, so the pass counts as the JAX package's
delta method does (:func:`measure_sharded`): two unit counts (1 and 2),
extrapolated to the stack, and
the sLSTM loop at two trip counts, extrapolated to the sequence
(:func:`_slstm_steps`); both exact (``tests/test_torch_dryrun.py``
holds them to the full count).

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k \
      [--multi-pod | --both-meshes]
  python -m repro_torch.launch.dryrun --all \
      [--out-dir experiments/dryrun_torch]

``--all`` writes every arch x shape on one card and at both pod meshes;
otherwise one card, or the pods with ``--multi-pod`` (2 x 16 x 16) or
``--both-meshes``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch

from ..checkpoint.npz import flat_state
from ..configs import ARCH_NAMES, INPUT_SHAPES, get_config
from ..models import ssm
from ..models.model import init_params
from ..models.sharding import logical_rules, rules_for_mesh
from ..optim import AdamWConfig
from . import roofline, shardings, specs, steps
from .mesh import (device_mesh, fake_group, make_production_mesh, mesh_tag,
                   n_batch_devices, shape_of)

MESH = "h100x1"                  # the record's device: one card
POD_MESHES = (make_production_mesh(), make_production_mesh(multi_pod=True))


def build_step(cfg, shape, opt_cfg=None):
    """(step function, its meta arguments) for (cfg, shape)."""
    opt_cfg = opt_cfg or AdamWConfig()
    window = specs.decode_window(cfg, shape)
    batch = specs.input_specs(cfg, shape)
    if shape.kind == "train":
        model, opt = steps.train_state_shapes(cfg, opt_cfg)
        fn = steps.make_train_step(cfg, opt_cfg, window=window,
                                   microbatches=cfg.train_microbatches)
        return fn, (model, opt, batch)
    model = init_params(cfg, device="meta")
    if shape.kind == "prefill":
        return steps.make_prefill_step(cfg, window=window), (model, batch)
    state = specs.decode_state_specs(cfg, shape)
    fn = steps.make_serve_step(cfg, window=window)
    return fn, (model, state, batch["tokens"], batch["pos"])


def state_bytes_per_device(cfg, shape, args, mesh) -> tuple[int, bool]:
    """(bytes of the step's arguments one device of ``mesh`` holds under
    the sharding plan, the FSDP decision)."""
    model, rest = args[0], args[1:]
    leaves = shardings.param_leaves(model.named_parameters())
    fsdp = shardings.use_fsdp(leaves, mesh, cfg)
    total = shardings.bytes_per_device(
        leaves, shardings.param_shardings(leaves, mesh, cfg), mesh)
    if shape.kind == "train":
        opt = shardings.opt_leaves(rest[0])
        total += shardings.bytes_per_device(
            opt, shardings.opt_shardings(opt, mesh, cfg), mesh)
    if shape.kind == "decode":
        total += shardings.bytes_per_device(
            flat_state(rest[0]), _flat_specs(rest[0], specs.
            decode_state_shardings(cfg, shape, mesh)), mesh)
    batch = specs.input_specs(cfg, shape)
    total += shardings.bytes_per_device(
        batch, shardings.batch_shardings(batch, mesh), mesh)
    return total, fsdp


def _flat_specs(state, spec, path: str = "") -> dict:
    """The decode state's spec tuples by the state's flat paths
    (``checkpoint.npz.flat_state``'s keys: a tuple's index is ``#i``)."""
    if isinstance(state, dict):
        parts = ((k, state[k], spec[k]) for k in state)
    elif isinstance(state, tuple):
        parts = ((f"#{i}", t, p) for i, (t, p) in enumerate(zip(state, spec)))
    else:
        return {path: spec}
    out = {}
    for k, t, p in parts:
        out.update(_flat_specs(t, p, f"{path}/{k}" if path else k))
    return out


def _delta_cfg(cfg, units: int):
    """``cfg`` cut to ``units`` units of its stack: layers, sLSTM or
    attention periods, the encoder's layers with the decoder's."""
    if cfg.family == "ssm":
        return dataclasses.replace(cfg, n_layers=units * cfg.slstm_every)
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=units * cfg.attn_every)
    if cfg.family == "audio":
        return dataclasses.replace(cfg, n_layers=units,
                                   n_encoder_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def count_cost(cfg, shape) -> dict:
    """The counted work of one run of the step: ``flops``,
    ``flops_float32`` and ``bytes``."""
    fn, args = build_step(cfg, shape)
    c = roofline.count_step(fn, *args)
    return {k: c[k] for k in ("flops", "flops_float32", "bytes")}


def count_one(cfg, shape) -> dict:
    """One counted meta run of the step of (cfg, shape) and what follows
    from it: the record's fields."""
    fn, args = build_step(cfg, shape)
    cost = roofline.count_step(fn, *args)
    leaves = shardings.param_leaves(args[0].named_parameters())
    n_params = roofline.count_params(leaves)
    n_active = roofline.count_active_params(cfg, leaves)
    tokens = shape.global_batch * (shape.seq_len
                                   if shape.kind != "decode" else 1)
    rec = {"run_s": round(cost["seconds"], 1), "flops": cost["flops"],
           "flops_float32": cost["flops_float32"],
           "bytes_accessed": cost["bytes"], "attention": cost["attention"],
           "state_bytes": cost["state_bytes"],
           "peak_bytes_estimate": cost["peak_bytes_estimate"],
           "fits_one_card": roofline.fits_one_card(
               cost["peak_bytes_estimate"]),
           "roofline": roofline.roofline_terms(
               {"flops": cost["flops"],
                "flops_float32": cost["flops_float32"],
                "bytes accessed": cost["bytes"]}),
           "state_bytes_per_device": {}, "fsdp": {},
           "n_params": n_params, "n_active_params": n_active,
           "model_flops": roofline.model_flops(cfg, n_params, n_active,
                                               tokens, shape.kind)}
    for mesh in POD_MESHES:
        n, fsdp = state_bytes_per_device(cfg, shape, args, mesh)
        rec["state_bytes_per_device"][mesh_tag(mesh)] = n
        rec["fsdp"][mesh_tag(mesh)] = fsdp
    if rec["flops"] > 0:
        rec["useful_flops_ratio"] = rec["model_flops"] / rec["flops"]
    return rec


# ---------------------------------------------------------------------------
# The sharded pass.
# ---------------------------------------------------------------------------

SLSTM_STEPS = (3, 4)     # the sLSTM loop's two counted trip counts


def build_sharded(cfg, shape, dm, opt_cfg=None):
    """(step function, its meta arguments placed by the plan on the
    ``DeviceMesh`` ``dm``, the logical rules) for (cfg, shape), as the JAX
    package's ``build_lowered``: ``moe_groups`` = the batch devices,
    ``seq_shard`` for train shapes, the accumulated microbatch gradients
    pinned to the AdamW moments' ZeRO-1 placements."""
    opt_cfg = opt_cfg or AdamWConfig()
    mesh = shape_of(dm)
    if cfg.family == "moe" and cfg.moe_groups == 1:
        cfg = dataclasses.replace(cfg, moe_groups=n_batch_devices(mesh))
    rules = rules_for_mesh(mesh, seq_shard=(cfg.seq_shard and
                                            shape.kind == "train"))
    window = specs.decode_window(cfg, shape)
    batch = shardings.shard_batch(specs.input_specs(cfg, shape), dm)
    if shape.kind == "train":
        model, opt = steps.train_state_shapes(cfg, opt_cfg)
        shardings.shard_model(model, dm, cfg)
        opt = shardings.shard_opt_state(opt, dm, cfg)
        mb = cfg.train_microbatches
        fn = steps.make_train_step(
            cfg, opt_cfg, window=window, microbatches=mb,
            grad_shardings=shardings.grad_placements(opt) if mb > 1
            else None)
        return fn, (model, opt, batch), rules
    model = shardings.shard_model(init_params(cfg, device="meta"), dm, cfg)
    if shape.kind == "prefill":
        return (steps.make_prefill_step(cfg, window=window), (model, batch),
                rules)
    state = shardings.shard_decode_state(
        specs.decode_state_specs(cfg, shape),
        specs.decode_state_shardings(cfg, shape, mesh), dm)
    return (steps.make_serve_step(cfg, window=window),
            (model, state, batch["tokens"], batch["pos"]), rules)


def _bare(t: torch.Tensor, tokens: int) -> torch.Tensor:
    """A bare tensor like ``t`` (B, k, ...) with ``tokens`` in dim 1, its
    dims laid out in the same order as ``t``'s, so that what reads it
    copies (or does not) as it would read the whole sequence's tensor."""
    order = sorted(range(t.ndim), key=lambda d: -t.stride(d))
    shape = [tokens if d == 1 else n for d, n in enumerate(t.shape)]
    return t.new_empty([shape[d] for d in order]).permute(
        *[order.index(d) for d in range(t.ndim)])


class _Cut(torch.autograd.Function):
    """gx (B, S, ...) -> its first ``k`` tokens, a view; the gradient back
    is a bare tensor of S tokens (:func:`_bare`).  Neither direction
    moves a byte that the counter sees, so a run of the loop over ``k``
    tokens counts the loop's own ops and no more."""

    @staticmethod
    def forward(ctx, gx, k):
        ctx.s = gx.shape[1]
        return gx[:, :k]

    @staticmethod
    def backward(ctx, g):
        return _bare(g, ctx.s), None


class _Pad(torch.autograd.Function):
    """y (B, k, ...) standing for the loop's (B, S, ...) output: a bare
    tensor of S tokens forward (:func:`_bare`), the first ``k`` tokens'
    gradient back (a view), again moving nothing the counter sees."""

    @staticmethod
    def forward(ctx, y, s):
        ctx.k = y.shape[1]
        return _bare(y, s)

    @staticmethod
    def backward(ctx, g):
        return g[:, :ctx.k], None


@contextlib.contextmanager
def _slstm_steps(k: int | None):
    """Run every sLSTM loop (``ssm.slstm_scan``, the model's own) over the
    first ``k`` tokens of its input, on the meta device; None leaves it
    whole.  The count of such a run is c + k t, t a token step's ops and
    c the rest of the step, exactly: :func:`_Cut` and :func:`_Pad` stand
    for the whole sequence at no cost, and every op inside the loop's
    call (the input's cast, the stack of the outputs) counts a token at a
    time.  Two such runs extrapolate to the S-token count, as the JAX
    package's ``_slstm_correction`` counts one step and multiplies."""
    if k is None:
        yield
        return
    real = ssm.slstm_scan

    def cut(r, gx, state):
        y, state = real(r, _Cut.apply(gx, k), state)
        return _Pad.apply(y, gx.shape[1]), state
    ssm.slstm_scan = cut
    try:
        yield
    finally:
        ssm.slstm_scan = real


def count_sharded(cfg, shape, mesh, *, slstm_steps: int | None = None
                  ) -> dict:
    """One counted meta run of the sharded step of (cfg, shape) on
    ``mesh`` (a ``MeshShape``), in a fake group of its size: a device's
    ``flops``, ``flops_float32`` and ``bytes``, and ``coll``, its
    collective operand bytes by kind."""
    with fake_group(mesh.size):
        dm = device_mesh(mesh)
        fn, args, rules = build_sharded(cfg, shape, dm)
        with logical_rules(rules, dm), _slstm_steps(slstm_steps):
            c, coll = roofline.collective_bytes(roofline.count_step, fn,
                                                *args)
    return {"flops": c["flops"], "flops_float32": c["flops_float32"],
            "bytes": c["bytes"], "coll": coll}


def _n_units(cfg) -> int:
    if cfg.family == "ssm":
        return cfg.n_layers // cfg.slstm_every
    if cfg.family == "hybrid":
        return cfg.n_layers // cfg.attn_every
    return cfg.n_layers


def _extrapolate(c1: dict, c2: dict, times: int) -> dict:
    """c1 + times * (c2 - c1), counter by counter (collectives by kind)."""
    def one(a, b):
        return a + times * (b - a)
    return {k: ({kk: one(c1[k][kk], c2[k][kk]) for kk in c1[k]}
                if isinstance(c1[k], dict) else one(c1[k], c2[k]))
            for k in c1}


def _loops(cfg, shape) -> bool:
    """Whether the step runs the sLSTM token loop over more tokens than
    the counted trip counts."""
    return (cfg.family == "ssm" and shape.kind != "decode"
            and shape.seq_len > SLSTM_STEPS[1])


def measure_sharded(cfg, shape, mesh) -> dict:
    """The sharded step's count by the JAX package's delta method: the 1-
    and 2-unit variants extrapolated to the stack's n units, c1 + (n -
    1)(c2 - c1); in the ssm family each variant's sLSTM loop counted at
    SLSTM_STEPS trip counts and extrapolated to the sequence the same way
    (every token step counts the same, the first and the last apart,
    which both counted runs share)."""
    n = _n_units(cfg)

    def units(u):
        c = _delta_cfg(cfg, u)
        if not _loops(cfg, shape):
            return count_sharded(c, shape, mesh)
        a, b = (count_sharded(c, shape, mesh, slstm_steps=k)
                for k in SLSTM_STEPS)
        return _extrapolate(a, b, (shape.seq_len - SLSTM_STEPS[0])
                            // (SLSTM_STEPS[1] - SLSTM_STEPS[0]))
    first = units(1)
    return _extrapolate(first, units(2), n - 1) if n > 1 else first


def run_sharded(arch: str, shape_name: str, mesh, *, cfg=None, shape=None,
                out_dir: str | None = None, verbose: bool = True) -> dict:
    """The record of the sharded pass of (arch, shape) at ``mesh`` (a
    ``MeshShape``; ``shape`` defaults to the named input shape).  The
    counts and the roofline are recorded on a single pod's mesh; the
    multi-pod record is the lowering proof and its collective bytes."""
    cfg = cfg or get_config(arch)
    shape = shape or INPUT_SHAPES[shape_name]
    tag = mesh_tag(mesh)
    rec = {"arch": arch, "shape": shape_name, "mesh": tag,
           "kind": shape.kind, "status": "ok"}
    if not cfg.supports_shape(shape_name):
        rec["status"] = "skipped"
        rec["reason"] = "enc-dec full attention: no 500k decode (DESIGN.md)"
        return _finish(rec, out_dir, verbose)
    t0 = time.time()
    try:
        cost = measure_sharded(cfg, shape, mesh)
        rec["collective_bytes"] = cost["coll"]
        rec["n_units"] = _n_units(cfg)
        if "pod" not in mesh.axis_names:
            coll = sum(cost["coll"].values())
            rec.update(flops=cost["flops"],
                       flops_float32=cost["flops_float32"],
                       bytes_accessed=cost["bytes"],
                       roofline=roofline.roofline_terms(
                           {"flops": cost["flops"],
                            "flops_float32": cost["flops_float32"],
                            "bytes accessed": cost["bytes"]}, coll))
            leaves = shardings.param_leaves(
                init_params(cfg, device="meta").named_parameters())
            n_params = roofline.count_params(leaves)
            n_active = roofline.count_active_params(cfg, leaves)
            tokens = shape.global_batch * (shape.seq_len
                                           if shape.kind != "decode" else 1)
            mf = roofline.model_flops(cfg, n_params, n_active, tokens,
                                      shape.kind)
            rec.update(n_params=n_params, n_active_params=n_active,
                       model_flops=mf, model_flops_per_chip=mf / mesh.size)
            if rec["flops"] > 0:
                # a device's counted FLOPs: compare like for like
                rec["useful_flops_ratio"] = (mf / mesh.size) / rec["flops"]
        # the counts' meta runs, every one of the delta method
        rec["run_s"] = rec["seconds"] = round(time.time() - t0, 1)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _finish(rec, out_dir, verbose)


def run_one(arch: str, shape_name: str, *, cfg=None,
            out_dir: str | None = None, verbose: bool = True) -> dict:
    cfg = cfg or get_config(arch)
    shape = INPUT_SHAPES[shape_name]
    rec = {"arch": arch, "shape": shape_name, "mesh": MESH,
           "kind": shape.kind, "status": "ok"}
    if not cfg.supports_shape(shape_name):
        rec["status"] = "skipped"
        rec["reason"] = "enc-dec full attention: no 500k decode (DESIGN.md)"
        return _finish(rec, out_dir, verbose)

    t0 = time.time()
    try:
        rec.update(count_one(cfg, shape))
        rec["seconds"] = round(time.time() - t0, 1)
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-2000:]
    return _finish(rec, out_dir, verbose)


def _finish(rec: dict, out_dir: str | None, verbose: bool) -> dict:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        fname = f"{rec['arch']}__{rec['shape']}__{rec['mesh']}.json"
        with open(os.path.join(out_dir, fname), "w") as f:
            json.dump(rec, f, indent=1)
    if verbose:
        r = rec.get("roofline", {})
        print(f"[dryrun] {rec['arch']:24s} {rec['shape']:12s} "
              f"{rec['mesh']:10s} {rec['status']:7s} "
              f"flops={rec.get('flops', 0):.3g} "
              f"dom={r.get('dominant', '-')}", flush=True)
    return rec


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true",
                    help="the sharded pass at 2x16x16 only")
    ap.add_argument("--both-meshes", action="store_true",
                    help="the sharded pass at 16x16 and 2x16x16")
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args()

    archs = ARCH_NAMES if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None \
        else [args.shape]
    if args.multi_pod:
        meshes = [POD_MESHES[1]]
    elif args.both_meshes:
        meshes = list(POD_MESHES)
    else:
        meshes = [MESH] + (list(POD_MESHES) if args.all else [])

    n_bad = 0
    for m in meshes:
        for a in archs:
            for s in shapes:
                rec = (run_one(a, s, out_dir=args.out_dir) if m == MESH
                       else run_sharded(a, s, m, out_dir=args.out_dir))
                n_bad += rec["status"] == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} dry-run combinations failed")


if __name__ == "__main__":
    main()
