"""Algorithm 1 end to end: distributed GBDT over W ranks, on the port.

Each rank samples candidates from its slice of the rows at data-read
time; each boosting round the pools are all-gathered and resampled from a
generator seeded alike on every rank (the paper's AllReduce-combine-
resample); gradient histograms are summed over the ranks inside the tree
builder.  The port of the JAX package's ``examples/distributed_gbdt.py``,
with ranks of a ``torch.distributed`` group (:mod:`repro_torch.launch.
distributed`) in place of forced host devices.

Run:  PYTHONPATH=src python -m repro_torch.launch.distributed_gbdt \\
          [--workers 8] [--device cpu]

``--device`` defaults to ``cuda`` and raises where there is no GPU; on
the card every rank shares it (gloo over CUDA tensors).
"""

from __future__ import annotations

import argparse
import time

import torch

import repro_torch
from ..core.distributed import fit_distributed
from ..data.tabular import make_dataset
from ..kernels.ops import device_of
from . import distributed as dist_lib

STRATEGIES = ("random", "weighted_quantile")


def _fit_each(x, y, cfgs, device):
    """On every rank: one distributed fit a config; rank 0's models, each
    with the bytes that crossed its collectives on this rank."""
    out = []
    for cfg in cfgs:
        before = dist_lib.collective_bytes
        model = fit_distributed(x, y, cfg, seed=0, device=device)
        out.append((model, dist_lib.collective_bytes - before))
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workers", type=int, default=8)
    p.add_argument("--device", default="cuda")
    p.add_argument("--n-train", type=int, default=32_768)
    p.add_argument("--n-test", type=int, default=8_192)
    p.add_argument("--trees", type=int, default=10)
    p.add_argument("--depth", type=int, default=5)
    args = p.parse_args(argv)
    device = device_of(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"ranks: {args.workers} on {name}")
    xtr, ytr, xte, yte, _ = make_dataset("higgs-like", args.n_train,
                                         args.n_test)

    # telemetry=True: per-round TrainReport with the loss and norms summed
    # over the ranks, and the estimated collective payload a round
    cfgs = [repro_torch.GBDTConfig(n_trees=args.trees, max_depth=args.depth,
                                   n_candidates=32, strategy=strat,
                                   telemetry=True) for strat in STRATEGIES]
    t0 = time.perf_counter()
    fits = dist_lib.run(_fit_each, args.workers, xtr, ytr, cfgs,
                        str(device), device=device)
    ranks_s = time.perf_counter() - t0
    results = {}
    for cfg, (m, measured) in zip(cfgs, fits):
        acc = repro_torch.accuracy(m, xte, yte)
        s = m.report.summarize()
        coll = s["collective_bytes"]
        print(f"  {cfg.strategy:18s} acc={acc:.4f}  "
              f"({args.workers} workers, Algorithm 1)")
        print(f"  {'':18s} loss {s['train_loss']['first']:.4f} -> "
              f"{s['train_loss']['final']:.4f}, "
              f"~{coll['per_round'] / 1024:.1f} KiB collectives/round "
              f"(all_gather {coll['all_gather_total'] / 1024:.1f} KiB + "
              f"psum {coll['psum_total'] / 1024:.1f} KiB total; "
              f"{measured / cfg.n_trees / 1024:.1f} KiB/round measured)")
        results[cfg.strategy] = dict(
            acc=acc, loss_first=s["train_loss"]["first"],
            loss_final=s["train_loss"]["final"],
            collective_bytes_per_round_estimate=coll["per_round"],
            collective_bytes_per_round_measured=measured / cfg.n_trees,
            fit_s=m.fit_seconds)

    # single-host reference
    cfg = repro_torch.GBDTConfig(n_trees=args.trees, max_depth=args.depth,
                                 n_candidates=32)
    m1 = repro_torch.fit(xtr, ytr, cfg,
                         torch.Generator(device=device).manual_seed(0),
                         device=device)
    results["single"] = dict(acc=repro_torch.accuracy(m1, xte, yte),
                             fit_s=m1.fit_seconds)
    print(f"  {'single-host':18s} acc={results['single']['acc']:.4f}")
    return {"device": name, "workers": args.workers, "results": results,
            "ranks_seconds": ranks_s}


if __name__ == "__main__":
    main()
