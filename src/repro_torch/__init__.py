"""PyTorch/CUDA port of the ``repro`` GBDT library, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its
module names and holds to it bit for bit where it can.  It trains with
every split-proposal strategy of the paper's comparison (random, the
weighted-quantile and GK sketches, uniform range, exact), with optional
per-round telemetry (``TrainReport``), through hand-written histogram
and split-gain kernels, and serves a trained forest (its own, or a
checkpoint of either package) through a hand-written traversal kernel::

    import repro_torch

    model = repro_torch.fit(x, y, repro_torch.GBDTConfig())  # device="cuda"
    margins = model.predict(x, output="margin")
    model = repro_torch.load_gbdt("model.npz")

``repro_torch.fit_distributed`` is the paper's Algorithm 1 on the ranks
of a ``torch.distributed`` group (``repro_torch.launch.distributed.run``
starts them; ``python -m repro_torch.launch.distributed_gbdt`` runs the
example).  ``repro_torch.core.rank_error`` holds the Theorem 1
machinery, and ``python -m repro_torch.launch.quickstart`` runs the
paper in a minute.

It also prefills the dense and moe LM families (``repro_torch.models``,
``repro_torch.launch.steps.make_prefill_step``) through a hand-written
flash-attention kernel, and serves them by greedy decode against a KV
cache (``make_serve_step``; ``python -m repro_torch.launch.serve``),
and trains every LM family (``make_train_step``, ``repro_torch.optim``;
``python -m repro_torch.launch.train``) through a hand-written backward
of the flash kernel.  Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .checkpoint import load_gbdt, model_from_numpy, save_gbdt
from .core.boosting import (GBDTConfig, GBDTModel, accuracy, fit,
                            fit_reference, mape)
from .core.distributed import fit_distributed
from .core.predict import forest_predict
from .core.tree import Forest, Tree
from .kernels.ops import HistSpec, TraverseSpec
from .obs import PredictReport, TrainReport

__all__ = [
    "Forest",
    "GBDTConfig",
    "GBDTModel",
    "HistSpec",
    "PredictReport",
    "TrainReport",
    "TraverseSpec",
    "Tree",
    "accuracy",
    "fit",
    "fit_distributed",
    "fit_reference",
    "forest_predict",
    "load_gbdt",
    "mape",
    "model_from_numpy",
    "save_gbdt",
]
