"""PyTorch/CUDA port of the ``repro`` GBDT library, for NVIDIA Hopper.

The JAX package ``repro`` is the reference; this package keeps its
module names and holds to it bit for bit where it can.  It trains with
the paper's random split proposal through hand-written histogram and
split-gain kernels, and serves a trained forest (its own, or a
checkpoint of either package) through a hand-written traversal kernel::

    import repro_torch

    model = repro_torch.fit(x, y, repro_torch.GBDTConfig())  # device="cuda"
    margins = model.predict(x, output="margin")
    model = repro_torch.load_gbdt("model.npz")

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

from .checkpoint import load_gbdt, model_from_numpy, save_gbdt
from .core.boosting import GBDTConfig, GBDTModel, accuracy, fit, mape
from .core.predict import forest_predict
from .core.tree import Forest, Tree
from .kernels.ops import HistSpec, TraverseSpec
from .obs import PredictReport

__all__ = [
    "Forest",
    "GBDTConfig",
    "GBDTModel",
    "HistSpec",
    "PredictReport",
    "TraverseSpec",
    "Tree",
    "accuracy",
    "fit",
    "forest_predict",
    "load_gbdt",
    "mape",
    "model_from_numpy",
    "save_gbdt",
]
