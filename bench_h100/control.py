"""Readings that set the limits of ``correct``: the program's, the
control's and the planted faults', on many seeds, at a cell's own size.

From the root of a checkout, on the card::

    python3 bench_h100/control.py --workload higgs.fit.random.k50 \
        --side control --seeds 11 12 13

``--side program`` runs the timed path for ``--seconds`` a seed (0: one
fit; the score cell wants a second, to keep as many requests as a run
judges) and judges it as a run does; ``--side
control`` puts the plain reference in bfloat16 in the program's place;
``--side fault:<name>`` plants a fault of ``faults.py`` in the program.
Each seed prints one JSON line with the numbers and whether the cell's
limits hold.  The benchmark's own runs never run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path


def main(argv=None) -> int:
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root), str(root / "src")]
    from bench_h100 import harness
    harness.environment(root)
    from bench_h100 import compare, faults, workloads
    import contextlib
    import torch

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--side", default="program")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    args = p.parse_args(argv)
    cell = harness.load_cell(args.workload)
    kind = cell["traffic"]["kind"]
    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 3
    for seed in args.seeds:
        t = time.perf_counter()
        if args.side == "control":
            numbers = workloads.control_numbers(cell, seed, "cuda")
        else:
            plant = contextlib.nullcontext()
            if args.side.startswith("fault:"):
                plant = faults.planted(kind, args.side.split(":", 1)[1])
            with plant:
                run = workloads.execute(cell, seed, args.seconds, False,
                                        "cuda", time.perf_counter())
            numbers = run.numbers
        print(json.dumps({
            "workload": args.workload, "side": args.side, "seed": seed,
            "numbers": numbers, "limits": cell["limits"],
            "where": None if args.side == "control" else run.where,
            "held": compare.held(numbers, cell["limits"]),
            "seconds": time.perf_counter() - t,
            "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
