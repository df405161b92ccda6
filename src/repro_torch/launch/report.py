"""Markdown tables of the port's dry-run records and telemetry.

A port of the JAX package's ``launch/report.py``: the §Dry-run and
§Roofline tables from the meta dry-run's records (``launch/dryrun.py``),
the §Telemetry table from a record holding a fit's ``TrainReport``
summary (``obs/report.py``) and the §Predict table from one holding
``PredictReport`` summaries (``obs/predict.py``).  The tables keep the
JAX package's columns and formats; where the port has no such number the
cell is ``-`` (a one-card record's collective bytes, a pod record's
state).  The dry-run table's time column is the meta run's seconds, its
"arg" and "temp" columns the step's state and the peak of what the run
made on one card, its collective column a pod record's collective
operand bytes a device.  The roofline table is printed for the one-card
records and for the ``pod16x16`` records (a device's counts, with the
collective term).  Its numbers are counts on the H100's constants and a
published inter-node rate, not measurements.

Usage: python -m repro_torch.launch.report [--dir experiments/dryrun_torch]
          [--section dryrun|roofline|telemetry|predict|both|all]
          [--bench-json FIT_RECORD] [--predict-json PREDICT_RECORD]
"""

from __future__ import annotations

import argparse
import glob
import json
import os


def load(dirname: str) -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(dirname, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def fmt_bytes(b) -> str:
    if b is None:
        return "-"
    return f"{b / 2**30:.2f}"


def _pods(r: dict) -> str:
    per = r.get("state_bytes_per_device") or {}
    fsdp = r.get("fsdp") or {}
    return " / ".join(f"{fmt_bytes(per[m])}{' fsdp' if fsdp.get(m) else ''}"
                      for m in ("pod16x16", "pod2x16x16") if m in per) \
        or "-"


def dryrun_table(recs: list[dict]) -> str:
    out = ["| arch | shape | mesh | status | meta run s | "
           "arg GB/dev | temp GB/dev | collective bytes/dev | "
           "fits 80 GB | state GB/dev pod16x16 / pod2x16x16 |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in recs:
        state, peak = r.get("state_bytes"), r.get("peak_bytes_estimate")
        temp = None if state is None or peak is None else peak - state
        fits = ("-" if "fits_one_card" not in r else
                {True: "yes", False: "no", None: "unknown"}[
                    r["fits_one_card"]])
        coll = r.get("collective_bytes")
        coll = "-" if coll is None else f"{sum(coll.values()):.3g}"
        out.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} | {r['status']} | "
            f"{r.get('run_s', 0)} | {fmt_bytes(state)} | {fmt_bytes(temp)} | "
            f"{coll} | {fits} | "
            f"{_pods(r)} |")
    return "\n".join(out)


def roofline_table(recs: list[dict]) -> str:
    out = ["| arch | shape | compute ms | memory ms | collective ms | "
           "dominant | useful-FLOPs ratio | params |",
           "|---|---|---|---|---|---|---|---|"]
    for r in recs:
        if "roofline" not in r:
            continue
        rf = r["roofline"]
        coll = rf.get("collective_s")
        out.append(
            f"| {r['arch']} | {r['shape']} | "
            f"{rf['compute_s']*1e3:.2f} | {rf['memory_s']*1e3:.2f} | "
            f"{'-' if coll is None else f'{coll*1e3:.2f}'} | "
            f"**{rf['dominant']}** | "
            f"{r.get('useful_flops_ratio', 0):.2f} | "
            f"{r.get('n_params', 0)/1e9:.2f}B |")
    skips = [r for r in recs if r.get("status") == "skipped"]
    for r in skips:
        out.append(f"| {r['arch']} | {r['shape']} | - | - | - | skipped | "
                   f"- | {r.get('reason', '')} |")
    return "\n".join(out)


def telemetry_table(rec: dict) -> str:
    """Markdown view of a fit record's telemetry block (a
    ``TrainReport.summarize()`` under ``telemetry.summary``)."""
    tel = rec.get("telemetry")
    if not tel:
        return "(no telemetry block in the record)"
    s = tel["summary"]
    wl = rec.get("workload", {})
    out = ["| workload | warm fit s | overhead vs plain | loss first→final | "
           "splits total | best gain max |",
           "|---|---|---|---|---|---|",
           f"| n={wl.get('n')} T={wl.get('n_trees')} "
           f"d={wl.get('max_depth')} | {tel['warm_fit_s']} | "
           f"{tel['overhead_pct_vs_scanned_warm']:+.1f}% | "
           f"{s['train_loss']['first']:.4f}→{s['train_loss']['final']:.4f} | "
           f"{s['splits']['total']} | {s['best_gain']['max']:.2f} |"]
    su = rec.get("scatter_updates")
    if su:
        out += ["", "| scatter updates direct | subtract | reduction |",
                "|---|---|---|",
                f"| {su['direct_total']:.0f} | {su['subtract_total']:.0f} | "
                f"{su['reduction_ratio']:.2f}x |"]
    return "\n".join(out)


def predict_table(rec: dict) -> str:
    """Markdown view of an inference record (``PredictReport`` summaries
    per engine variant + the per-tree-scan baseline)."""
    variants = rec.get("variants")
    if not variants:
        return "(no variants block in the record)"
    wl = rec.get("workload", {})
    out = [f"workload: {wl.get('n_trees')} trees x depth "
           f"{wl.get('max_depth')}, {wl.get('rows')} rows x "
           f"{wl.get('n_features')} features (chunk "
           f"{wl.get('tree_chunk')})", "",
           "| engine | rows/s | p50 ms | p99 ms | speedup vs scan |",
           "|---|---|---|---|---|"]
    for name, v in variants.items():
        s = v["summary"]
        speed = s.get("speedup_vs_scan")
        out.append(
            f"| {name} | {s['rows_per_s']:,.0f} | "
            f"{s['latency_ms']['p50']:.2f} | {s['latency_ms']['p99']:.2f} | "
            f"{'-' if speed is None else f'{speed:.1f}x'} |")
    return "\n".join(out)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", default="experiments/dryrun_torch")
    ap.add_argument("--section",
                    choices=["dryrun", "roofline", "telemetry", "predict",
                             "both", "all"],
                    default="both")
    ap.add_argument("--bench-json", help="fit record for the telemetry "
                    "section")
    ap.add_argument("--predict-json", help="inference record for the "
                    "predict section")
    args = ap.parse_args()
    for section, path in (("telemetry", args.bench_json),
                          ("predict", args.predict_json)):
        if args.section in (section, "all") and path is None:
            ap.error(f"--section {args.section} needs --"
                     f"{'bench' if section == 'telemetry' else 'predict'}"
                     "-json")
    recs = load(args.dir)
    if args.section in ("dryrun", "both", "all"):
        print("## §Dry-run (meta device, counts on the H100's constants)\n")
        print(dryrun_table(recs))
        print()
    if args.section in ("roofline", "both", "all"):
        print("## §Roofline (one H100 SXM, counted terms)\n")
        print(roofline_table([r for r in recs if r.get("mesh") == "h100x1"]))
        print()
        pods = [r for r in recs if r.get("mesh") == "pod16x16"]
        if pods:
            print("## §Roofline at pod16x16 (a device's counted terms, "
                  "collective bytes over 50 GB/s)\n")
            print(roofline_table(pods))
            print()
    if args.section in ("telemetry", "all"):
        print("## §Telemetry (TrainReport)\n")
        with open(args.bench_json) as fh:
            print(telemetry_table(json.load(fh)))
    if args.section in ("predict", "all"):
        print("## §Predict (batched inference engine)\n")
        with open(args.predict_json) as fh:
            print(predict_table(json.load(fh)))


if __name__ == "__main__":
    main()
