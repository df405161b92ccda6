"""GBDT serving entry point: microbatched batched-forest inference.

Drives the level-synchronous inference engine
(:mod:`repro_torch.core.predict`) the way a serving process would: a
stream of fixed-size microbatches, warmed up first, per-request
wall-clock latencies, p50/p99 + rows/s summarized as a
:class:`repro_torch.obs.PredictReport`.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve_gbdt \
      --trees 500 --depth 6 --features 32 --microbatch 4096 \
      --requests 32 --device cuda [--binned] [--ckpt model.npz] \
      [--data-shards N] [--json predict_report.json]

With ``--ckpt`` the model comes from :func:`repro_torch.checkpoint.
load_gbdt` (a checkpoint of either package); otherwise a synthetic
forest of the requested shape is built.  ``--device`` defaults to
``cuda`` and raises where there is no GPU; pass ``--device cpu`` to run
the plain PyTorch path.

``--data-shards N`` serves from N ranks (:mod:`repro_torch.launch.
distributed`): each rank predicts its slice of the rows of every
microbatch and the margins are gathered in rank order.  The traversal is
row-wise, so the margins are bit-identical to unsharded serving.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from ..checkpoint import load_gbdt, model_from_numpy
from ..core import boosting
from ..core.predict import DEFAULT_TREE_CHUNK
from ..obs import PredictReport
from . import distributed as dist_lib


def synthetic_gbdt(*, n_trees: int, max_depth: int, n_features: int,
                   n_candidates: int = 32, seed: int = 0,
                   passthrough_frac: float = 0.1, device="cuda",
                   **config_overrides) -> boosting.GBDTModel:
    """A random-but-valid GBDTModel of the requested shape.

    Valid means the trained-model invariants hold, so every predict path
    (raw, binned, per-tree oracle) agrees on it: candidates are a fixed
    sorted grid, each internal node's threshold IS
    ``candidates[feature, split_bin]``, and passthrough nodes carry the
    (-1, +inf, last-bin) sentinel triple.  The draws from
    ``default_rng(seed)`` are the JAX package's, in its order, so both
    packages build the same forest for the same seed.
    """
    rng = np.random.default_rng(seed)
    f, k = n_features, n_candidates
    n_inner, n_leaves = 2 ** max_depth - 1, 2 ** max_depth
    cands = np.sort(rng.normal(size=(f, k)).astype(np.float32), axis=1)

    feature = rng.integers(0, f, size=(n_trees, n_inner)).astype(np.int32)
    split_bin = rng.integers(0, k, size=(n_trees, n_inner)).astype(np.int32)
    passthrough = rng.random(size=(n_trees, n_inner)) < passthrough_frac
    feature = np.where(passthrough, -1, feature).astype(np.int32)
    split_bin = np.where(passthrough, k, split_bin).astype(np.int32)
    threshold = cands[feature.clip(0), split_bin.clip(max=k - 1)]
    threshold = np.where(passthrough, np.inf, threshold).astype(np.float32)
    leaf_value = (0.1 * rng.normal(size=(n_trees, n_leaves))
                  ).astype(np.float32)

    cfg = boosting.GBDTConfig(
        n_trees=n_trees, max_depth=max_depth, n_candidates=k,
        repropose_each_round=False, **config_overrides)
    arrays = {"forest/feature": feature, "forest/split_bin": split_bin,
              "forest/threshold": threshold,
              "forest/leaf_value": leaf_value, "candidates": cands[None]}
    return model_from_numpy(arrays, cfg, 0.0, device)


def request_batches(model: boosting.GBDTModel, *, microbatch: int,
                    n_requests: int, seed: int) -> list[np.ndarray]:
    """The host microbatches :func:`serve` sends, from ``seed``."""
    n_features = (model.bin_edges.shape[0] if model.bin_edges is not None
                  else int(model.forest.feature.max()) + 1)
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(microbatch, n_features)).astype(np.float32)
            for _ in range(n_requests)]


def shard_predict(model: boosting.GBDTModel, x, *, group=None,
                  **predict_kw) -> torch.Tensor:
    """``model.predict(x, **predict_kw)`` from every rank of ``group``:
    rank r predicts the r-th slice of the rows, and the results are
    gathered in rank order, so every rank returns all of them."""
    world, rank = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[0]
    per = -(-n // world)
    part = model.predict(x[rank * per:(rank + 1) * per], **predict_kw)
    part = torch.nn.functional.pad(part, (0, per - part.shape[0]))
    return torch.cat(dist_lib.all_gather(part, group))[:n]


def serve(model: boosting.GBDTModel, *, microbatch: int = 4096,
          n_requests: int = 32, binned: bool = False,
          backend: str | None = None, tree_chunk: int | None = None,
          data_shards: int = 0, seed: int = 0,
          output: str = "margin") -> PredictReport:
    """Run the microbatched serving loop and return its telemetry.

    Each request takes a host (numpy) microbatch to the model's device,
    predicts (binning it first when ``binned``) and waits for the result.
    The first microbatch is served twice before timing starts, which
    builds the kernels at their first use outside the timed loop.

    With ``data_shards`` every rank of the default group (of that many
    ranks) calls this, and each request is :func:`shard_predict`.
    """
    cfg = model.config
    batches = request_batches(model, microbatch=microbatch,
                              n_requests=n_requests, seed=seed)
    n_features = batches[0].shape[1]
    on_cuda = model.device.type == "cuda"
    kw = dict(output=output, binned=binned, backend=backend,
              tree_chunk=tree_chunk)
    if data_shards:
        world = dist.get_world_size() if dist.is_initialized() else 0
        if world != data_shards:
            raise ValueError(f"data_shards={data_shards} needs a group of "
                             f"that many ranks (found {world}); start them "
                             "with launch.distributed.run")
        predict = lambda xb: shard_predict(model, xb, **kw)   # noqa: E731
    else:
        predict = lambda xb: model.predict(xb, **kw)          # noqa: E731

    def request(xb: np.ndarray) -> None:
        predict(xb)
        if on_cuda:
            torch.cuda.synchronize(model.device)

    for _ in range(2):
        request(batches[0])

    lat = np.empty((n_requests,), np.float64)
    for i, xb in enumerate(batches):
        t0 = time.perf_counter()
        request(xb)
        lat[i] = time.perf_counter() - t0

    return PredictReport(
        latencies_s=lat, rows_per_request=microbatch,
        engine={
            "n_trees": cfg.n_trees, "max_depth": cfg.max_depth,
            "n_features": int(n_features),
            "tree_chunk": tree_chunk or DEFAULT_TREE_CHUNK,
            "backend": backend or cfg.backend, "binned": bool(binned),
            "data_shards": int(data_shards), "device": str(model.device),
        })


def _model(args) -> boosting.GBDTModel:
    if args.ckpt:
        return load_gbdt(args.ckpt, device=args.device)
    return synthetic_gbdt(n_trees=args.trees, max_depth=args.depth,
                          n_features=args.features,
                          n_candidates=args.candidates, device=args.device)


def _serve(args) -> PredictReport:
    return serve(_model(args), microbatch=args.microbatch,
                 n_requests=args.requests, binned=args.binned,
                 backend=args.backend, tree_chunk=args.tree_chunk,
                 data_shards=args.data_shards, output=args.output)


def main(argv=None) -> PredictReport:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--ckpt", default=None,
                   help="serve a checkpointed model (either package's)")
    p.add_argument("--trees", type=int, default=500)
    p.add_argument("--depth", type=int, default=6)
    p.add_argument("--features", type=int, default=32)
    p.add_argument("--candidates", type=int, default=32)
    p.add_argument("--microbatch", type=int, default=4096)
    p.add_argument("--requests", type=int, default=32)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU) or cpu")
    p.add_argument("--backend", default=None, help="auto|cuda|ref")
    p.add_argument("--tree-chunk", type=int, default=None,
                   help="trees per chunk of the plain version (CPU); "
                        "no effect on the card, where a request is one "
                        "launch")
    p.add_argument("--binned", action="store_true",
                   help="traverse on bin ids (binning timed per request)")
    p.add_argument("--data-shards", type=int, default=0,
                   help="serve from this many ranks, each predicting its "
                        "slice of every microbatch")
    p.add_argument("--output", default="margin",
                   choices=["margin", "proba", "label"])
    p.add_argument("--json", default=None,
                   help="write the PredictReport JSON here")
    args = p.parse_args(argv)

    if args.data_shards:
        report = dist_lib.run(_serve, args.data_shards, args,
                              device=args.device)
    else:
        report = _serve(args)
    s = report.summarize()
    print(f"[serve_gbdt] {report.engine['n_trees']} trees x depth "
          f"{report.engine['max_depth']} | {s['rows_per_request']} rows/req "
          f"x {s['n_requests']} req | device={report.engine['device']} "
          f"backend={report.engine['backend']}"
          f"{' data_shards=%d' % args.data_shards if args.data_shards else ''}"
          f"{' binned' if report.engine['binned'] else ''}", flush=True)
    print(f"[serve_gbdt] {s['rows_per_s']:,.0f} rows/s | p50 "
          f"{s['latency_ms']['p50']:.2f} ms | p99 "
          f"{s['latency_ms']['p99']:.2f} ms", flush=True)
    if args.json:
        report.to_json(args.json)
        print(f"[serve_gbdt] wrote {args.json}", flush=True)
    return report


if __name__ == "__main__":
    main()
