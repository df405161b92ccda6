"""Inference observability: latency/throughput telemetry for serving.

``PredictReport`` is the host-side record the serving loop
(:mod:`repro_torch.launch.serve_gbdt`) emits: per-request wall-clock
latencies plus the workload shape, summarized into throughput and tail
percentiles.  The schema (``repro.obs.PredictReport/v1``) is the JAX
package's, so a report from either package reads the same.
"""

from __future__ import annotations

import json
from typing import NamedTuple

import numpy as np

SCHEMA = "repro.obs.PredictReport/v1"


class PredictReport(NamedTuple):
    """Latency record of one serving/benchmark run.

    Attributes:
      latencies_s: per-request (per-microbatch) wall-clock seconds,
        warm — warmup/compile requests excluded.
      rows_per_request: rows served per request (microbatch size).
      engine: workload description — free-form but conventionally
        n_trees / max_depth / tree_chunk / backend / binned / n_features.
      baseline_rows_per_s: optional reference throughput (the per-tree
        scan) for the speedup field; 0 disables it.
    """
    latencies_s: np.ndarray
    rows_per_request: int
    engine: dict
    baseline_rows_per_s: float = 0.0

    @property
    def n_requests(self) -> int:
        return int(np.asarray(self.latencies_s).shape[0])

    def summarize(self) -> dict:
        """Scalar summary (everything JSON-serialisable): throughput is
        total rows over total wall-clock; percentiles are per-request."""
        lat = np.asarray(self.latencies_s, np.float64)
        if lat.size == 0:
            raise ValueError("PredictReport needs at least one request")
        total_s = float(lat.sum())
        rows = float(self.rows_per_request) * lat.size
        rows_per_s = rows / total_s if total_s > 0 else float("inf")
        out = {
            "n_requests": self.n_requests,
            "rows_per_request": int(self.rows_per_request),
            "rows_per_s": rows_per_s,
            "latency_ms": {
                "p50": float(np.percentile(lat, 50) * 1e3),
                "p99": float(np.percentile(lat, 99) * 1e3),
                "mean": float(lat.mean() * 1e3),
                "max": float(lat.max() * 1e3),
            },
        }
        if self.baseline_rows_per_s > 0:
            out["baseline_rows_per_s"] = float(self.baseline_rows_per_s)
            out["speedup_vs_scan"] = rows_per_s / self.baseline_rows_per_s
        return out

    def to_json(self, path: str | None = None, *, indent: int = 1) -> str:
        """Serialise (schema + engine + summary + raw latencies);
        optionally write to ``path``."""
        rec = {"schema": SCHEMA,
               "engine": dict(self.engine),
               "summary": self.summarize(),
               "latencies_s": [float(v) for v in
                               np.asarray(self.latencies_s, np.float64)]}
        s = json.dumps(rec, indent=indent)
        if path is not None:
            with open(path, "w") as fh:
                fh.write(s)
        return s
