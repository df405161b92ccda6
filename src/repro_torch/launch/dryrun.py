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

No compile on placeholder devices, no multi-pod lowering proof and no
collective term: the port has no HLO, no SPMD partitioner, and one card.

The ssm family's sLSTM is a Python loop over tokens, and each step of it
is a few dozen meta ops at a few hundred microseconds each: xlstm-125m's
full runs are the sweep's slowest (PERF.md gives their seconds).

Usage:
  python -m repro_torch.launch.dryrun --arch glm4-9b --shape train_4k
  python -m repro_torch.launch.dryrun --all \
      [--out-dir experiments/dryrun_torch]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

from ..checkpoint.npz import flat_state
from ..configs import ARCH_NAMES, INPUT_SHAPES, get_config
from ..models.model import init_params
from ..optim import AdamWConfig
from . import roofline, shardings, specs, steps
from .mesh import make_production_mesh, mesh_tag

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
    ap.add_argument("--out-dir", default="experiments/dryrun_torch")
    args = ap.parse_args()

    archs = ARCH_NAMES if args.all or args.arch is None else [args.arch]
    shapes = list(INPUT_SHAPES) if args.all or args.shape is None \
        else [args.shape]

    n_bad = 0
    for a in archs:
        for s in shapes:
            rec = run_one(a, s, out_dir=args.out_dir)
            n_bad += rec["status"] == "error"
    if n_bad:
        raise SystemExit(f"{n_bad} dry-run combinations failed")


if __name__ == "__main__":
    main()
