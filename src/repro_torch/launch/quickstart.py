"""Quickstart: the paper in a minute, on the port.

Trains a GBDT with the paper's random split-point proposal and with the
XGBoost-style weighted-quantile sketch on a synthetic SUSY-like dataset,
then prints the accuracy parity (Table 2's claim), a per-round
:class:`repro_torch.TrainReport`, and the Theorem 1 rank-error curve
(Fig. 2's claim).  The port of the JAX package's
``examples/quickstart.py``, without its trace count (the port compiles
nothing).

Run:  PYTHONPATH=src python -m repro_torch.launch.quickstart [--device cpu]

``--device`` defaults to ``cuda`` and raises where there is no GPU.
"""

from __future__ import annotations

import argparse

import torch

import repro_torch
from ..core import rank_error
from ..data.tabular import make_dataset
from ..kernels.ops import device_of


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = device_of(args.device)
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    print(f"device: {name}")

    print("=== 1. GBDT: random sampling (S) vs quantile sketch (Q) ===")
    xtr, ytr, xte, yte, _ = make_dataset("susy-like", 20_000, 5_000)
    results = {}
    for strat in ("random", "weighted_quantile"):
        cfg = repro_torch.GBDTConfig(n_trees=20, max_depth=6,
                                     n_candidates=32, strategy=strat)
        gen = torch.Generator(device=device).manual_seed(0)
        m = repro_torch.fit(xtr, ytr, cfg, gen, device=device)
        results[strat] = dict(
            acc=repro_torch.accuracy(m, xte, yte),
            fit_s=m.fit_seconds,
            trees=m.forest.n_trees)
    for k, v in results.items():
        print(f"  {k:18s} acc={v['acc']:.4f} "
              f"fit={v['fit_s']:.2f}s forest={v['trees']} trees")
    gap = abs(results["random"]["acc"]
              - results["weighted_quantile"]["acc"])
    print(f"  accuracy gap = {gap:.4f}  (paper: ~0, Table 2)")

    print("\n=== 2. Telemetry: per-round TrainReport ===")
    cfg = repro_torch.GBDTConfig(n_trees=10, max_depth=5, n_candidates=32,
                                 telemetry=True)
    m = repro_torch.fit(xtr, ytr, cfg,
                        torch.Generator(device=device).manual_seed(0),
                        device=device)
    rep = m.report
    s = rep.summarize()
    print("  round  loss    grad_norm  splits  best_gain")
    for r in (0, rep.n_rounds // 2, rep.n_rounds - 1):
        print(f"  {r:5d}  {float(rep.train_loss[r]):.4f}  "
              f"{float(rep.grad_norm[r]):9.2f}  "
              f"{int(rep.n_splits[r]):6d}  "
              f"{float(rep.best_gain_max[r]):9.2f}")
    print(f"  loss {s['train_loss']['first']:.4f} -> "
          f"{s['train_loss']['final']:.4f} over {s['n_rounds']} rounds, "
          f"{s['splits']['total']} splits realized")

    print("\n=== 3. Theorem 1: E[rank error] = 1/(k+1) ===")
    out = rank_error.fig2_experiment(seed=0, n=1024, ks=[4, 16, 64],
                                     trials=16, device=device)
    print(f"  {'k':>4} {'random':>8} {'quantile':>9} {'1/(k+1)':>8}")
    for k, r, q, t in zip(out["k"], out["random"], out["quantile"],
                          out["theory"]):
        print(f"  {k:4d} {r:8.4f} {q:9.4f} {t:8.4f}")
    print("  -> quantile binning is no better than random (the claim).")
    return {"device": name, "table2": results, "report": s, "fig2": out}


if __name__ == "__main__":
    main()
