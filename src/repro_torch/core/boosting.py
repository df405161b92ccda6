"""Gradient-boosted decision trees: the model and its serving surface.

:class:`GBDTConfig` has exactly the JAX package's fields and defaults,
so ``GBDTConfig(**json)`` on either side accepts the other's checkpoint
(the backend keeps the JAX vocabulary; :func:`repro_torch.kernels.ops.
backend_name` maps it).  Training (``fit``) arrives with the training
slice; a model reaches this package through a checkpoint or
:func:`repro_torch.checkpoint.model_from_numpy`.
"""

from __future__ import annotations

import dataclasses

import torch

from . import binning, predict as predict_lib, tree as tree_lib
from ..kernels.ops import TraverseSpec


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


@dataclasses.dataclass
class GBDTModel:
    config: GBDTConfig
    forest: tree_lib.Forest             # stacked (n_trees, ...) ensemble
    base_score: float
    candidates: torch.Tensor            # (rounds_proposed, f, k): n_trees
    #                                     when the trainer re-proposed
    #                                     each round, else 1 (fixed grid)

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
