"""The run of one cell: arguments, the cell's files, the card, the result.

``main`` is what ``run.py`` calls.  It reads ``BENCHMARK.json`` at the
root of the checkout, finds the cell's configuration, traffic and limits
files and its metrics' readers by name, refuses to run without the card
(or cards) the cell asks for, runs the cell (``workloads.execute``), and
prints the result as the last line of standard output, after the numbers
compared and their limits as the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def environment(root: Path = ROOT) -> None:
    """Set, before torch is imported, what a run of the benchmark holds
    fixed: the program's and torch's build and kernel caches at fixed
    paths inside the checkout, and the CUDA allocator's expandable
    segments.  Without them the dense binning's 52 GiB int64 copy at 5M x
    28 x 50, freed and split a round, leaves no block for the next round
    (an out-of-memory error with 51 GiB reserved and free)."""
    cache = root / "build" / "bench_h100_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(cache / sub)
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"


class CellError(RuntimeError):
    """The run cannot give a result."""


def load_cell(workload: str, root: Path = ROOT) -> dict:
    """The cell ``workload`` of ``root/BENCHMARK.json`` with its
    configuration, traffic and limits read, and the metrics it reports
    with and without a trace."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise CellError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    named = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if workload in m.get("workloads", [workload] if m["moves"]
                                  in named else [])]
    bench_dir = root / bench["paths"][0]
    return {
        "name": workload, "chips": cell["chips"],
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads(
            (bench_dir / "traffic" / f"{cell['traffic']}.json").read_text()),
        "limits": json.loads(
            (bench_dir / "limits" / f"{workload}.json").read_text()),
        "end_to_end": e2e, "per_layer": layer, "bench_dir": bench_dir}


def reader(name: str, bench_dir: Path = BENCH):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = bench_dir / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "bench_h100_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metric_values(metrics: list[dict], run, bench_dir: Path = BENCH) -> dict:
    """Each metric's reading, left out where its reader finds nothing."""
    out = {}
    for m in metrics:
        value = reader(m["name"], bench_dir)(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def forbidden_modules(names=None) -> list[str]:
    """The modules among ``names`` (default: those loaded) whose top-level
    name is that of the JAX package or of JAX itself, compared whole:
    ``repro_torch`` is not ``repro``."""
    names = list(sys.modules) if names is None else names
    return sorted(m for m in names if m.split(".")[0] in FORBIDDEN)


def _finite(v: float) -> float:
    return v if math.isfinite(v) else sys.float_info.max


def checks(numbers: dict, limits: dict) -> dict:
    """``{number: [reading, limit]}``, in the order of the limits file."""
    return {key: [_finite(numbers[key]), limits.get(key)]
            for key in [*limits, *numbers] if key in numbers}


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def measure(cell: dict, seed: int, seconds: float, trace: bool, device,
            t0: float, peak_bytes) -> tuple[dict, object, list[str]]:
    """Run ``cell`` on ``device`` and make its result line: (the result
    without its checks, the run, the forbidden modules loaded by the time
    the window closed or after).  ``peak_bytes()`` is read once the window
    has closed, before the program's state is freed and the reference
    runs."""
    import torch
    from . import compare, workloads
    seen = {}

    def after_window(run):
        seen["bytes"] = peak_bytes()
        seen["modules"] = forbidden_modules()

    run = workloads.execute(cell, seed, seconds, trace, device, t0,
                            before_judge=after_window)
    found = sorted(set(seen["modules"]) | set(forbidden_modules()))
    metrics = cell["per_layer"] if trace else cell["end_to_end"]
    cuda = torch.device(device).type == "cuda"
    info = {"platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
            "count": cell["chips"], "memory_peak_bytes": seen["bytes"]}
    result = {"correct": compare.held(run.numbers, cell["limits"])
              and run.failed == 0,
              "attempted": run.attempted, "failed": run.failed,
              "metrics": metric_values(metrics, run, cell["bench_dir"]),
              "device": info}
    if trace:
        info.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        result["breakdown"] = {"device_ops": run.trace.top_ops(),
                               "idle_gaps": run.trace.top_idle()}
    return result, run, found


def main(argv, t0: float) -> int:
    args = parse(argv)
    try:
        cell = load_cell(args.workload)
    except (OSError, KeyError, ValueError, CellError) as e:
        print(f"bench_h100: cannot read the cell: {e!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"bench_h100: {cell['name']} needs {cell['chips']} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    result, run, found = measure(
        cell, args.seed, args.seconds, bool(args.trace), "cuda", t0,
        torch.cuda.max_memory_allocated)
    if found:
        print(f"bench_h100: the run loaded {found}", file=sys.stderr)
        return 4
    result["checks"] = checks(run.numbers, cell["limits"])
    print(f"bench_h100: worst at {json.dumps(run.where)}", file=sys.stderr)
    for key, (value, limit) in result["checks"].items():
        print(f"check {key} {value!r} limit {limit!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
