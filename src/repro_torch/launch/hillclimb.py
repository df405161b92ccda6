"""§Perf hillclimbing harness: re-count a dry-run combo with config
overrides and report the roofline-term deltas against the recorded
baseline.

A port of the JAX package's ``launch/hillclimb.py`` over the meta
dry-run (``launch/dryrun.py``): the terms are counts on one H100's
constants, not measurements.  On one card (``--mesh h100x1``, the
default) there is no collective term; at ``--mesh pod16x16`` the step
runs under the sharding plan and the collective term moves with the
knobs that act only on a mesh (``seq_shard``, ``train_microbatches``,
``moe_groups``).  ``--fast`` counts the 1-unit variant of the stack with
and without the overrides (the JAX package compiles the first and reads
the second from the baseline record; the port's records carry no
``delta_detail``).

Usage:
  python -m repro_torch.launch.hillclimb --arch zamba2-2.7b --shape train_4k \
      --set train_microbatches=1 --set remat=False --tag mb1_noremat
  python -m repro_torch.launch.hillclimb --arch deepseek-moe-16b \
      --shape prefill_32k --set moe_dispatch=sort --tag sort --fast
  python -m repro_torch.launch.hillclimb --arch glm4-9b --shape train_4k \
      --set seq_shard=False --tag no_sp --mesh pod16x16 --fast
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..configs import INPUT_SHAPES, get_config
from . import dryrun
from .mesh import mesh_tag


def parse_override(s: str):
    k, v = s.split("=", 1)
    for cast in (int, float):
        try:
            return k, cast(v)
        except ValueError:
            pass
    if v in ("True", "False"):
        return k, v == "True"
    return k, v


def _delta(new: float, base: float) -> str:
    return f"({(new - base) / base * 100:+.1f}%)" if base else ""


def _load(path: str) -> dict | None:
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--set", action="append", default=[],
                    help="cfg overrides, e.g. --set train_microbatches=1")
    ap.add_argument("--tag", required=True)
    ap.add_argument("--out-dir", default="experiments/hillclimb_torch")
    ap.add_argument("--baseline-dir", default="experiments/dryrun_torch")
    ap.add_argument("--fast", action="store_true",
                    help="count only the 1-unit variant, with and without "
                         "the overrides (exact for per-layer effects)")
    ap.add_argument("--mesh", default=dryrun.MESH,
                    choices=[dryrun.MESH, mesh_tag(dryrun.POD_MESHES[0])],
                    help="one card, or the sharded step at 16 x 16")
    args = ap.parse_args()
    pod = dryrun.POD_MESHES[0] if args.mesh != dryrun.MESH else None

    base_cfg = get_config(args.arch)
    overrides = dict(parse_override(s) for s in args.set)
    cfg = dataclasses.replace(base_cfg, **overrides)
    os.makedirs(args.out_dir, exist_ok=True)
    out_path = os.path.join(args.out_dir,
                            f"{args.arch}__{args.shape}__{args.tag}.json")

    if args.fast:
        shape = INPUT_SHAPES[args.shape]
        c1, b1 = ((dryrun.count_sharded(dryrun._delta_cfg(c, 1), shape, pod)
                   if pod else dryrun.count_cost(dryrun._delta_cfg(c, 1),
                                                 shape))
                  for c in (cfg, base_cfg))
        rec = {"arch": args.arch, "shape": args.shape, "status": "ok",
               "c1": c1, "baseline_c1": b1, "tag": args.tag,
               "overrides": overrides}
        with open(out_path, "w") as f:
            json.dump(rec, f, indent=1)
        print(f"[hillclimb-c1] {args.arch} x {args.shape} [{args.tag}] "
              f"{overrides}")
        for k in ("flops", "bytes"):
            print(f"  c1 {k:6s} {c1[k]:.4g}  baseline {b1[k]:.4g}  "
                  f"{_delta(c1[k], b1[k])}")
        if pod:
            c, b = (sum(x["coll"].values()) for x in (c1, b1))
            print(f"  c1 {'coll':6s} {c:.4g}  baseline {b:.4g}  "
                  f"{_delta(c, b)}")
        return

    base = _load(os.path.join(
        args.baseline_dir, f"{args.arch}__{args.shape}__{args.mesh}.json"))
    rec = (dryrun.run_sharded(args.arch, args.shape, pod, cfg=cfg,
                              verbose=False) if pod else
           dryrun.run_one(args.arch, args.shape, cfg=cfg, verbose=False))
    rec["tag"] = args.tag
    rec["overrides"] = overrides
    with open(out_path, "w") as f:
        json.dump(rec, f, indent=1)
    if rec["status"] != "ok":
        print(f"[hillclimb] {args.tag}: {rec['status'].upper()} "
              f"{rec.get('error', rec.get('reason'))}")
        print(rec.get("traceback", "")[-1500:])
        raise SystemExit(1)

    r = rec["roofline"]
    print(f"[hillclimb] {args.arch} x {args.shape} [{args.tag}] "
          f"{overrides}")
    for term in ("compute_s", "memory_s", "collective_s"):
        if r[term] is None:
            print(f"  {term:13s} {'-':>10s}")
            continue
        line = f"  {term:13s} {r[term]*1e3:10.2f} ms"
        if base and "roofline" in base:
            line += f"   {_delta(r[term], base['roofline'][term])}"
        print(line)
    if not pod:
        print(f"  state GB      {rec['state_bytes']/2**30:10.1f}"
              f"   peak GB {rec['peak_bytes_estimate']/2**30:.1f}")
    print(f"  dominant      {r['dominant']}")


if __name__ == "__main__":
    main()
