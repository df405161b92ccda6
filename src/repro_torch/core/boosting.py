"""Gradient-boosted decision trees: the trainer and the model.

:class:`GBDTConfig` has exactly the JAX package's fields and defaults,
so ``GBDTConfig(**json)`` on either side accepts the other's checkpoint
(the backend keeps the JAX vocabulary; :func:`repro_torch.kernels.ops.
backend_name` maps it).

:func:`fit` trains with the paper's random split proposal.  Its round
loop is the JAX package's round step, in the same order of operations:
grad/hess -> propose -> bin -> ``build_tree`` -> ``margin + lr *
leaf_value[node]``.  On the card every level of every tree is one
histogram launch and one split-gain launch.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import binning, predict as predict_lib, proposal, tree as tree_lib
from ..kernels.ops import HistSpec, TraverseSpec


@dataclasses.dataclass(frozen=True)
class GBDTConfig:
    n_trees: int = 20
    max_depth: int = 6
    learning_rate: float = 0.3
    l2: float = 1.0
    gamma: float = 0.0
    min_child_weight: float = 1.0
    n_candidates: int = 32              # k; nbins = k + 1
    strategy: str = "random"            # split proposal of the trainer
    objective: str = "logistic"         # 'logistic' | 'mse'
    repropose_each_round: bool = True   # paper re-proposes per iteration
    backend: str = "auto"               # kernel backend (JAX vocabulary)
    telemetry: bool = False             # per-round training telemetry
    subtract: bool = False              # histogram-subtraction growth

    @property
    def nbins(self) -> int:
        return self.n_candidates + 1

    def hist_spec(self) -> HistSpec:
        """The fit-wide histogram workload this config implies: frontier
        width 2^(max_depth-1) nodes, one batched level per tree depth."""
        return HistSpec(n_nodes=2 ** max(self.max_depth - 1, 0),
                        nbins=self.nbins,
                        n_levels=max(self.max_depth, 1),
                        backend=self.backend,
                        subtract=self.subtract)


@dataclasses.dataclass
class GBDTModel:
    config: GBDTConfig
    forest: tree_lib.Forest             # stacked (n_trees, ...) ensemble
    base_score: float
    candidates: torch.Tensor            # (rounds_proposed, f, k): n_trees
    #                                     when the trainer re-proposed
    #                                     each round, else 1 (fixed grid)
    proposal_seconds: float = 0.0       # host-side strategies only; the
    #                                     random strategy proposes inside
    #                                     the round loop
    fit_seconds: float = 0.0

    @property
    def trees(self) -> list[tree_lib.Tree]:
        """Per-tree views of the forest."""
        return tree_lib.forest_trees(self.forest)

    @property
    def device(self) -> torch.device:
        return self.forest.feature.device

    def to(self, device) -> "GBDTModel":
        """The same model with its tensors on ``device``."""
        return dataclasses.replace(
            self, forest=tree_lib.Forest(*(a.to(device) for a in self.forest)),
            candidates=self.candidates.to(device))

    @property
    def bin_edges(self) -> torch.Tensor | None:
        """The (f, k) training candidate grid when every tree shares it;
        None when the trainer re-proposed a grid per round (the binned
        path needs one grid that reproduces every recorded threshold)."""
        if self.candidates.shape[0] == 1:
            return self.candidates[0]
        return None

    def bin_features(self, x) -> torch.Tensor:
        """Bin raw rows against the training grid for binned predict.

        Returns (n, f) uint8 bin ids in [0, k] (int32 when nbins > 256) on
        the model's device; NaN lands in the last bin.
        """
        edges = self.bin_edges
        if edges is None:
            raise ValueError(
                "binned predict needs a fixed candidate grid; this model "
                "re-proposed candidates per round (strategy="
                f"{self.config.strategy!r}, repropose_each_round=True). "
                "Train with repropose_each_round=False or a host-side "
                "strategy to serve binned.")
        x = torch.as_tensor(x, device=self.device).to(torch.float32)
        bins = binning.bin_features(x, edges)
        if self.config.nbins <= 256:
            return bins.to(torch.uint8)
        return bins

    def predict(self, x, *, output: str = "label", binned: bool = False,
                backend: str | None = None,
                tree_chunk: int | None = None) -> torch.Tensor:
        """Evaluate the ensemble (batched level-synchronous engine).

        Args:
          x: (n, f) rows (array or tensor); moved to the model's device.
          output: 'label' -- hard 0/1 for logistic, the predicted value
            for mse; 'margin' -- the raw additive score; 'proba' --
            sigmoid of the margin (logistic only).
          binned: traverse on integer bin ids instead of float
            thresholds.  ``x`` may be raw floats (binned here against
            :attr:`bin_edges`) or ids from :meth:`bin_features`.
          backend: 'auto' | 'cuda' | 'ref' (or a JAX package name);
            default the config's, and 'auto' follows the model's device.
          tree_chunk: trees per traversal launch.
        """
        x = torch.as_tensor(x, device=self.device)
        if binned and x.is_floating_point():
            x = self.bin_features(x)
        elif binned and self.bin_edges is None:
            raise ValueError("binned predict needs a fixed candidate grid "
                             "(see GBDTModel.bin_features)")
        spec = TraverseSpec(
            tree_chunk=tree_chunk or predict_lib.DEFAULT_TREE_CHUNK,
            binned=binned, backend=backend or self.config.backend)
        m = predict_lib.margin(
            self.forest, x, self.base_score, self.config.learning_rate,
            max_depth=self.config.max_depth, spec=spec)
        if output == "margin":
            return m
        if self.config.objective != "logistic":
            if output == "proba":
                raise ValueError(
                    f"output='proba' needs a logistic objective, got "
                    f"{self.config.objective!r}")
            return m                       # 'label' for regression = value
        p = torch.sigmoid(m)
        if output == "proba":
            return p
        if output == "label":
            return (p > 0.5).to(torch.float32)
        raise ValueError(f"unknown output {output!r}")


def device_of(device) -> torch.device:
    """``device`` as a ``torch.device``; 'cuda' raises without a GPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on "
            "the CPU")
    return device


def grad_hess(margin: torch.Tensor, y: torch.Tensor, objective: str):
    """First/second order stats of the loss with respect to the margin.

    ``torch.sigmoid`` and ``jax.nn.sigmoid`` may round 1 ulp apart, so
    logistic statistics are close to the JAX package's, not equal; the
    mse ones are the same float32 operations.
    """
    if objective == "logistic":
        p = torch.sigmoid(margin)
        return p - y, p * (1 - p)
    if objective == "mse":
        return margin - y, torch.ones_like(margin)
    raise ValueError(f"unknown objective {objective!r}")


def _mean(y: torch.Tensor) -> torch.Tensor:
    # XLA:CPU divides by n as a product with float32(1/n); torch.mean
    # divides.  For 0/1 labels the sum is exact, so this is the JAX mean.
    return y.sum() * (1.0 / y.shape[0])


def _base_score(y: torch.Tensor, objective: str) -> float:
    if objective == "logistic":
        p = float(torch.clamp(_mean(y), 1e-6, 1 - 1e-6))
        return float(np.log(p / (1 - p)))
    return float(_mean(y))


def fit(x, y, cfg: GBDTConfig, generator: torch.Generator | None = None,
        *, candidates=None, device="cuda") -> GBDTModel:
    """Train a GBDT model with random split proposal.

    Args:
      x: (n, f) features (array or tensor), moved to ``device`` as float32.
      y: (n,) labels ({0,1} for logistic, real for mse).
      cfg: the config; only ``strategy='random'`` is ported.
      generator: draws the candidate grids; a ``torch.Generator`` on
        ``device``, seeded 0 when None.  Unused with ``candidates``.
      candidates: an injected candidate grid, in the convention of
        :attr:`GBDTModel.candidates`: (n_trees, f, k) when
        ``cfg.repropose_each_round``, else (1, f, k).  The RNG streams of
        the two packages differ, so parity with the JAX package's ``fit``
        feeds its ``model.candidates`` here.
      device: where to train; 'cuda' (the default) raises without a GPU.

    Returns:
      The model, on ``device``.
    """
    if cfg.strategy != "random":
        raise NotImplementedError(
            f"strategy {cfg.strategy!r} is not ported yet (ROADMAP queue 1 "
            "item 2); the port trains with strategy='random'")
    if cfg.telemetry:
        raise NotImplementedError(
            "telemetry=True needs TrainReport, which lands with obs/ "
            "(ROADMAP queue 1 item 3)")
    device = device_of(device)
    x = torch.as_tensor(x, device=device).to(torch.float32)
    y = torch.as_tensor(y, device=device).to(torch.float32)
    n, f = x.shape
    rounds = cfg.n_trees if cfg.repropose_each_round else 1
    if candidates is not None:
        candidates = torch.as_tensor(candidates, device=device).to(
            torch.float32)
        want = (rounds, f, cfg.n_candidates)
        if tuple(candidates.shape) != want:
            raise ValueError(f"candidates must have shape {want} "
                             f"(repropose_each_round="
                             f"{cfg.repropose_each_round}), got "
                             f"{tuple(candidates.shape)}")
    elif generator is None:
        generator = torch.Generator(device=device).manual_seed(0)
    t_fit0 = time.perf_counter()

    base = _base_score(y, cfg.objective)
    margin = torch.full((n,), base, dtype=torch.float32, device=device)
    spec = cfg.hist_spec()
    trees, cands = [], []
    for r in range(cfg.n_trees):
        if r < rounds:
            if candidates is not None:
                c = candidates[r]
            else:
                c = proposal.random_candidates(generator, x, cfg.n_candidates)
            bins = binning.bin_features(x, c)
            cands.append(c)
        g, h = grad_hess(margin, y, cfg.objective)
        t, node = tree_lib.build_tree(
            bins, torch.stack([g, h], 1), cands[-1],
            max_depth=cfg.max_depth, spec=spec, l2=cfg.l2, gamma=cfg.gamma,
            min_child_weight=cfg.min_child_weight, return_leaf_nodes=True)
        # growth already routed every row to its leaf
        margin = margin + cfg.learning_rate * t.leaf_value[node.long()]
        trees.append(t)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return GBDTModel(cfg, tree_lib.forest_from_trees(trees), base,
                     torch.stack(cands),
                     fit_seconds=time.perf_counter() - t_fit0)


def leaf_rounding(model: GBDTModel, x, y) -> torch.Tensor:
    """(n_trees, 2^max_depth) float64: how far each leaf of ``model``,
    fitted on ``(x, y)``, lies from the leaf that its rows' exact grad/hess
    sums give (float64 sums of the same float32 g/h).

    The rounding of the sums a leaf came from: on the CPU a float32 sum in
    row order, on the card a fixed-point sum within a few ulps of exact.
    The rounds are replayed as ``fit`` runs them (same margins, so the
    same g/h); the rows reach their leaves by the model's split bins.
    """
    cfg = model.config
    forest = model.forest
    dev = forest.leaf_value.device
    x = torch.as_tensor(x, device=dev).to(torch.float32)
    y = torch.as_tensor(y, device=dev).to(torch.float32)
    margin = torch.full((x.shape[0],), model.base_score, dtype=torch.float32,
                        device=dev)
    out = []
    for t in range(forest.n_trees):
        bins = binning.bin_features(
            x, model.candidates[min(t, model.candidates.shape[0] - 1)])
        node = torch.zeros((x.shape[0],), dtype=torch.long, device=dev)
        for depth in range(cfg.max_depth):
            heap = 2 ** depth - 1 + node
            col = forest.feature[t][heap].clamp(min=0).long()
            left = torch.gather(bins, 1, col[:, None])[:, 0] \
                <= forest.split_bin[t][heap]
            node = 2 * node + (~left).long()
        g, h = grad_hess(margin, y, cfg.objective)
        exact = torch.zeros((2 ** cfg.max_depth, 2), dtype=torch.float64,
                            device=dev)
        exact.index_add_(0, node, torch.stack([g, h], 1).double())
        leaf = forest.leaf_value[t]
        out.append((leaf.double() + exact[:, 0] / (exact[:, 1] + cfg.l2))
                   .abs())
        margin = margin + cfg.learning_rate * leaf[node]
    return torch.stack(out)


def accuracy(model: GBDTModel, x, y) -> float:
    if model.config.objective != "logistic":
        raise ValueError("accuracy is for classification")
    lbl = model.predict(x, output="label")
    y = torch.as_tensor(y, device=lbl.device)
    return float(((lbl > 0.5) == (y > 0.5)).to(torch.float32).mean())


def mape(model: GBDTModel, x, y) -> float:
    p = model.predict(x, output="label")   # regression 'label' = value
    y = torch.as_tensor(y, device=p.device).to(torch.float32)
    denom = torch.where(y == 0, torch.ones_like(y), y)
    return float(((p - y) / denom).abs().mean()) * 100
